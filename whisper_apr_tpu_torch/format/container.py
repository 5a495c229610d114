# Copied from whisper_apr_tpu/format/container.py (host-side numpy, no JAX); keep the two in step.
"""The `.apr` model container — binary-compatible reader/writer.

Binary layout (format v1, little-endian throughout; reference:
src/format/mod.rs:63-70 constants, AprHeader::parse at :162,
TensorDescriptor::parse at :393, AprReader::new at :484):

    magic "APR1"                      4 B
    header                           48 B
      [0:2]  version u16
      [2]    model_type u8
      [3]    quantization u8 (0=f32 1=f16 2=int8 3=int4)
      [4]    compressed u8
      [5:7]  n_tensors u16
      [7]    flags u8 (bit0 has_vocab, bit1 has_filterbank)
      [8:48] 10 x u32: n_vocab, n_audio_ctx, n_audio_state, n_audio_head,
             n_audio_layer, n_text_ctx, n_text_state, n_text_head,
             n_text_layer, n_mels
    tensor index                     96 B per tensor
      [0:48]  name (null-terminated utf-8, max 47 chars)
      [48:56] offset u64 (relative to tensor-data section)
      [56:64] size u64 (bytes)
      [64:72] n_elements u64
      [72:88] shape[4] u32
      [88]    n_dims u8
    [int8 only] scale table           4 B f32 per tensor
    tensor data                       concatenated
    [vocab section]                   u32 byte-len + Vocabulary bytes
    [filterbank section]              u32 byte-len + (n_mels u32, n_freqs u32, f32 data)
    crc32                             4 B (over everything before it)
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import ModelConfig, MODEL_TYPE_NAMES
from ..errors import FormatError
from .checksum import crc32

MAGIC = b"APR1"
FORMAT_VERSION = 1
HEADER_SIZE = 48
TENSOR_INDEX_ENTRY_SIZE = 96

# Quantization codes (reference: src/format/mod.rs:75-100; Q4_K carried
# via realizar k-quants in the reference, quantized.rs:88-380)
QUANT_F32 = 0
QUANT_F16 = 1
QUANT_INT8 = 2
QUANT_INT4 = 3
QUANT_Q4K = 4
QUANT_Q5K = 5
QUANT_Q6K = 6

_QUANT_NAMES = {QUANT_F32: "f32", QUANT_F16: "f16", QUANT_INT8: "int8",
                QUANT_INT4: "int4", QUANT_Q4K: "q4k", QUANT_Q5K: "q5k",
                QUANT_Q6K: "q6k"}

# k-quant family: super-block bytes per 256 values (ops/q4k.py,
# ops/kquants.py carry the codecs)
_KQUANT_BLOCK_BYTES = {QUANT_Q4K: 144, QUANT_Q5K: 176, QUANT_Q6K: 210}


def _kquant_dequantize(code: int, raw: "np.ndarray") -> "np.ndarray":
    if code == QUANT_Q4K:
        from ..ops.q4k import dequantize_q4k_raw
        return dequantize_q4k_raw(raw)
    if code == QUANT_Q5K:
        from ..ops.kquants import dequantize_q5k_raw
        return dequantize_q5k_raw(raw)
    from ..ops.kquants import dequantize_q6k_raw
    return dequantize_q6k_raw(raw)


def _kquant_quantize(code: int, flat: "np.ndarray") -> "np.ndarray":
    if code == QUANT_Q4K:
        from ..ops.q4k import quantize_q4k_raw
        return quantize_q4k_raw(flat)
    if code == QUANT_Q5K:
        from ..ops.kquants import quantize_q5k_raw
        return quantize_q5k_raw(flat)
    from ..ops.kquants import quantize_q6k_raw
    return quantize_q6k_raw(flat)


@dataclasses.dataclass
class AprHeader:
    """Parsed .apr header (reference: src/format/mod.rs:116-160)."""

    version: int = FORMAT_VERSION
    model_type: int = 0
    quantization: int = QUANT_F32
    compressed: bool = False
    n_tensors: int = 0
    has_vocab: bool = False
    has_filterbank: bool = False
    n_vocab: int = 51_865
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4
    n_mels: int = 80

    @staticmethod
    def parse(data: bytes) -> "AprHeader":
        """Parse 48-byte header (reference: src/format/mod.rs:162-230)."""
        if len(data) < HEADER_SIZE:
            raise FormatError("header too short")
        version = struct.unpack_from("<H", data, 0)[0]
        if version > FORMAT_VERSION:
            raise FormatError(f"unsupported format version: {version}")
        model_type = data[2]
        quantization = data[3]
        if quantization not in _QUANT_NAMES:
            raise FormatError(f"invalid quantization type: {quantization}")
        compressed = data[4] != 0
        n_tensors = struct.unpack_from("<H", data, 5)[0]
        flags = data[7]
        hyper = struct.unpack_from("<10I", data, 8)
        return AprHeader(
            version=version,
            model_type=model_type,
            quantization=quantization,
            compressed=compressed,
            n_tensors=n_tensors,
            has_vocab=bool(flags & 0x01),
            has_filterbank=bool(flags & 0x02),
            n_vocab=hyper[0],
            n_audio_ctx=hyper[1],
            n_audio_state=hyper[2],
            n_audio_head=hyper[3],
            n_audio_layer=hyper[4],
            n_text_ctx=hyper[5],
            n_text_state=hyper[6],
            n_text_head=hyper[7],
            n_text_layer=hyper[8],
            n_mels=hyper[9],
        )

    def to_bytes(self) -> bytes:
        """Serialize header (reference: src/format/mod.rs:233-263)."""
        out = bytearray(HEADER_SIZE)
        struct.pack_into("<H", out, 0, self.version)
        out[2] = self.model_type
        out[3] = self.quantization
        out[4] = 1 if self.compressed else 0
        struct.pack_into("<H", out, 5, self.n_tensors)
        out[7] = (1 if self.has_vocab else 0) | ((1 if self.has_filterbank else 0) << 1)
        struct.pack_into(
            "<10I", out, 8,
            self.n_vocab, self.n_audio_ctx, self.n_audio_state, self.n_audio_head,
            self.n_audio_layer, self.n_text_ctx, self.n_text_state, self.n_text_head,
            self.n_text_layer, self.n_mels,
        )
        return bytes(out)

    @staticmethod
    def from_config(config: ModelConfig, quantization: int = QUANT_F32,
                    compressed: bool = False) -> "AprHeader":
        """Header from a ModelConfig (reference: src/format/mod.rs:290-330)."""
        return AprHeader(
            model_type=config.model_type_code,
            quantization=quantization,
            compressed=compressed,
            n_vocab=config.n_vocab,
            n_audio_ctx=config.n_audio_ctx,
            n_audio_state=config.n_audio_state,
            n_audio_head=config.n_audio_head,
            n_audio_layer=config.n_audio_layer,
            n_text_ctx=config.n_text_ctx,
            n_text_state=config.n_text_state,
            n_text_head=config.n_text_head,
            n_text_layer=config.n_text_layer,
            n_mels=config.n_mels,
        )

    def to_model_config(self) -> ModelConfig:
        """Recover ModelConfig (reference: src/format/mod.rs:246 to_model_config)."""
        return ModelConfig(
            model_type=MODEL_TYPE_NAMES.get(self.model_type, "tiny"),
            n_vocab=self.n_vocab,
            n_audio_ctx=self.n_audio_ctx,
            n_audio_state=self.n_audio_state,
            n_audio_head=self.n_audio_head,
            n_audio_layer=self.n_audio_layer,
            n_text_ctx=self.n_text_ctx,
            n_text_state=self.n_text_state,
            n_text_head=self.n_text_head,
            n_text_layer=self.n_text_layer,
            n_mels=self.n_mels,
        )

    @property
    def quantization_name(self) -> str:
        return _QUANT_NAMES[self.quantization]


@dataclasses.dataclass
class TensorDescriptor:
    """One 96-byte tensor index entry (reference: src/format/mod.rs:380-460)."""

    name: str
    offset: int
    size: int
    n_elements: int
    shape: Tuple[int, int, int, int]
    n_dims: int

    @staticmethod
    def parse(data: bytes) -> "TensorDescriptor":
        if len(data) < TENSOR_INDEX_ENTRY_SIZE:
            raise FormatError("tensor descriptor too short")
        name_bytes = data[0:48]
        end = name_bytes.find(b"\x00")
        if end < 0:
            end = 48
        name = name_bytes[:end].decode("utf-8", errors="replace")
        offset, size, n_elements = struct.unpack_from("<3Q", data, 48)
        shape = struct.unpack_from("<4I", data, 72)
        n_dims = data[88]
        return TensorDescriptor(name, offset, size, n_elements, shape, n_dims)

    def to_bytes(self) -> bytes:
        out = bytearray(TENSOR_INDEX_ENTRY_SIZE)
        name_bytes = self.name.encode("utf-8")[:47]
        out[: len(name_bytes)] = name_bytes
        struct.pack_into("<3Q", out, 48, self.offset, self.size, self.n_elements)
        struct.pack_into("<4I", out, 72, *self.shape)
        out[88] = self.n_dims
        return bytes(out)

    @property
    def dims(self) -> Tuple[int, ...]:
        return tuple(self.shape[: self.n_dims]) if self.n_dims else ()


@dataclasses.dataclass
class MelFilterbankData:
    """Embedded slaney filterbank section (reference: src/format/mod.rs:905-990)."""

    n_mels: int
    n_freqs: int
    data: np.ndarray  # float32, shape (n_mels, n_freqs)

    def __post_init__(self) -> None:
        self.data = np.asarray(self.data, dtype=np.float32).reshape(self.n_mels, self.n_freqs)

    def to_bytes(self) -> bytes:
        return (struct.pack("<II", self.n_mels, self.n_freqs)
                + self.data.astype("<f4").tobytes())

    @staticmethod
    def from_bytes(data: bytes) -> "MelFilterbankData":
        if len(data) < 8:
            raise FormatError("filterbank header too short")
        n_mels, n_freqs = struct.unpack_from("<II", data, 0)
        expected = n_mels * n_freqs * 4
        if len(data) < 8 + expected:
            raise FormatError(
                f"filterbank data too short: expected {8 + expected} bytes, got {len(data)}")
        arr = np.frombuffer(data, dtype="<f4", count=n_mels * n_freqs, offset=8)
        return MelFilterbankData(n_mels, n_freqs, arr.reshape(n_mels, n_freqs).copy())


class AprReader:
    """Read tensors, vocabulary, and filterbank out of .apr bytes.

    (reference: src/format/mod.rs:466-780 AprReader)

    Tensor data is accessed zero-copy through numpy views over the file
    buffer; dequantization of int8 models happens lazily per tensor.
    """

    def __init__(self, data: bytes) -> None:
        if len(data) < 4 or data[:4] != MAGIC:
            raise FormatError("invalid magic: not an .apr file")
        self.data = data
        self.header = AprHeader.parse(data[4:])
        n_tensors = self.header.n_tensors

        index_start = 4 + HEADER_SIZE
        index_size = n_tensors * TENSOR_INDEX_ENTRY_SIZE
        if n_tensors > 0 and len(data) < index_start + index_size:
            raise FormatError("file too short for tensor index")

        # int8 models carry a per-tensor f32 scale table between the index
        # and the tensor data (reference: src/format/mod.rs:496-501)
        scale_table_size = n_tensors * 4 if self.header.quantization == QUANT_INT8 else 0
        self._scale_table_start = index_start + index_size
        self.tensor_data_offset = index_start + index_size + scale_table_size

        self.tensors: List[TensorDescriptor] = []
        self._by_name: Dict[str, int] = {}
        buf = memoryview(data)
        for i in range(n_tensors):
            start = index_start + i * TENSOR_INDEX_ENTRY_SIZE
            desc = TensorDescriptor.parse(bytes(buf[start:start + TENSOR_INDEX_ENTRY_SIZE]))
            self.tensors.append(desc)
            self._by_name[desc.name] = i

        # compressed files carry `u32 comp_len + payload` in place of the
        # raw tensor data. The payload is a STANDARD LZ4 frame (spec
        # v1.6.1, detected by its magic — the framing the reference's
        # LZ4_MAGIC constant implies, compress.rs:34); the round-1 private
        # block layout is still read for back-compat.
        self._payload: Optional[bytes] = None
        self._sections_after = None
        if self.header.compressed and n_tensors > 0:
            from .compress import (LZ4_MAGIC, decompress_blocks,
                                   lz4_frame_decompress)
            start = self.tensor_data_offset
            if start + 4 > len(data):
                raise FormatError("truncated compressed payload header")
            (comp_len,) = struct.unpack_from("<I", data, start)
            end = start + 4 + comp_len
            if end > len(data):
                raise FormatError("truncated compressed payload")
            blob = data[start + 4: end]
            if len(blob) >= 4 and struct.unpack_from("<I", blob)[0] == LZ4_MAGIC:
                self._payload = lz4_frame_decompress(blob)
            else:  # legacy private framing (round-1 files)
                self._payload = decompress_blocks(blob)
            self._sections_after = end

    @staticmethod
    def from_file(path: str, use_mmap: bool = True) -> "AprReader":
        """Open an .apr file, memory-mapped by default.

        The reference plans zero-copy weight access with a simulated mmap
        layer (reference: src/memory/mmap.rs); here it is a REAL OS mmap —
        tensor loads are zero-copy numpy views over the page cache until the
        device transfer (a 3 GB large-v3 file costs no host RAM up front).
        """
        if use_mmap:
            import mmap as _mmap
            f = open(path, "rb")
            try:
                mm = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
            except (ValueError, OSError):
                data = f.read()
                f.close()
                return AprReader(data)
            reader = AprReader(mm)
            reader._file = f  # keep alive with the mapping
            return reader
        with open(path, "rb") as f:
            return AprReader(f.read())

    # -- tensor access ------------------------------------------------------
    def find_tensor(self, name: str) -> Optional[TensorDescriptor]:
        idx = self._by_name.get(name)
        return self.tensors[idx] if idx is not None else None

    def tensor_names(self) -> List[str]:
        return [t.name for t in self.tensors]

    def scale_for(self, name: str) -> float:
        """Per-tensor int8 dequant scale (reference: src/format/mod.rs:632-660)."""
        if self.header.quantization != QUANT_INT8:
            raise FormatError("scale table only present for int8 models")
        idx = self._by_name[name]
        off = self._scale_table_start + idx * 4
        return struct.unpack_from("<f", self.data, off)[0]

    def load_raw(self, name: str) -> np.ndarray:
        """Raw stored values (int8 or f32) without dequantization."""
        idx = self._by_name.get(name)
        if idx is None:
            raise FormatError(f"tensor not found: {name}")
        desc = self.tensors[idx]
        if self._payload is not None:
            blob, start = self._payload, desc.offset
        else:
            blob, start = self.data, self.tensor_data_offset + desc.offset
        count = desc.n_elements
        if self.header.quantization == QUANT_INT8:
            end = start + count
            if end > len(blob):
                raise FormatError("tensor data out of bounds")
            arr = np.frombuffer(blob, dtype=np.int8, count=count, offset=start)
        elif self.header.quantization == QUANT_F16:
            # f16 models store every tensor as little-endian float16
            # (reference: header quantization=1 at src/format/mod.rs:63-70,
            # converted f16->f32 on load at src/cli/model_loader.rs:172-192)
            end = start + count * 2
            if end > len(blob):
                raise FormatError("tensor data out of bounds")
            arr = np.frombuffer(blob, dtype="<f2", count=count, offset=start)
        elif (self.header.quantization in _KQUANT_BLOCK_BYTES
              and desc.size != count * 4):
            # k-quant files store matmul weights as raw super-blocks
            # (q4k 144 B / q5k 176 B / q6k 210 B per 256 values, flat
            # stream padded to a 256 multiple) and everything else as
            # f32; the two are distinguished by the descriptor's byte size
            block_bytes = _KQUANT_BLOCK_BYTES[self.header.quantization]
            n_sb = (count + 255) // 256
            if desc.size != n_sb * block_bytes:
                raise FormatError(
                    f"tensor {desc.name}: size {desc.size} matches neither "
                    f"f32 nor {self.header.quantization_name} for "
                    f"{count} elements")
            end = start + desc.size
            if end > len(blob):
                raise FormatError("tensor data out of bounds")
            arr = np.frombuffer(blob, dtype=np.uint8, count=desc.size,
                                offset=start)
            return arr.reshape(n_sb, block_bytes)
        else:
            end = start + count * 4
            if end > len(blob):
                raise FormatError("tensor data out of bounds")
            arr = np.frombuffer(blob, dtype="<f4", count=count, offset=start)
        dims = desc.dims
        return arr.reshape(dims) if dims else arr

    def load_tensor(self, name: str) -> np.ndarray:
        """Load a tensor as f32, dequantizing int8 via the scale table and
        Q4_K super-blocks via the k-quant codec.

        (reference: src/format/mod.rs:610-660 load_tensor /
        read_int8_tensor_dequantized, dequant rule ``f32 = int8 * scale``;
        Q4_K dequant quantized.rs:164)
        """
        raw = self.load_raw(name)
        if self.header.quantization == QUANT_INT8:
            return raw.astype(np.float32) * self.scale_for(name)
        if self.header.quantization == QUANT_F16:
            return raw.astype(np.float32)
        if (self.header.quantization in _KQUANT_BLOCK_BYTES
                and raw.dtype == np.uint8):
            desc = self.tensors[self._by_name[name]]
            flat = _kquant_dequantize(self.header.quantization, raw[None])[0]
            return flat[:desc.n_elements].reshape(desc.dims)
        return raw.astype(np.float32, copy=False)

    def total_tensor_data_size(self) -> int:
        return sum(t.size for t in self.tensors)

    # -- aux sections --------------------------------------------------------
    def _section_after_tensors(self) -> int:
        if self._sections_after is not None:
            return self._sections_after
        return self.tensor_data_offset + self.total_tensor_data_size()

    def read_vocabulary_bytes(self) -> Optional[bytes]:
        """Raw vocabulary section (reference: src/format/mod.rs:695-725)."""
        if not self.header.has_vocab:
            return None
        start = self._section_after_tensors()
        if start + 4 > len(self.data):
            return None
        (size,) = struct.unpack_from("<I", self.data, start)
        if start + 4 + size > len(self.data):
            return None
        return self.data[start + 4: start + 4 + size]

    def read_mel_filterbank(self) -> Optional[MelFilterbankData]:
        """Embedded filterbank (reference: src/format/mod.rs:736-780)."""
        if not self.header.has_filterbank:
            return None
        start = self._section_after_tensors()
        if self.header.has_vocab:
            if start + 4 > len(self.data):
                return None
            (vocab_size,) = struct.unpack_from("<I", self.data, start)
            start += 4 + vocab_size
        if start + 4 > len(self.data):
            return None
        (size,) = struct.unpack_from("<I", self.data, start)
        if start + 4 + size > len(self.data):
            return None
        return MelFilterbankData.from_bytes(self.data[start + 4: start + 4 + size])

    def verify_crc(self) -> bool:
        """Validate the trailing CRC32 (reference: src/format/mod.rs:1150)."""
        if len(self.data) < 4:
            return False
        (stored,) = struct.unpack_from("<I", self.data, len(self.data) - 4)
        return crc32(self.data[:-4]) == stored


class AprWriter:
    """Serialize a model into .apr bytes (reference: src/format/mod.rs:897-1160).

    f32 by default; pass ``quantization=QUANT_INT8`` for the int8 writer
    behavior (per-tensor absmax scales, reference: src/format/mod.rs:1181-1356
    AprWriterInt8 and QuantizedTensorData::from_f32 at :849).
    """

    def __init__(self, header: AprHeader) -> None:
        self.header = header
        self._tensors: List[Tuple[str, np.ndarray]] = []
        self._vocab_bytes: Optional[bytes] = None
        self._filterbank: Optional[MelFilterbankData] = None

    @staticmethod
    def from_config(config: ModelConfig, quantization: int = QUANT_F32) -> "AprWriter":
        return AprWriter(AprHeader.from_config(config, quantization))

    def add_tensor(self, name: str, values: np.ndarray) -> None:
        if len(name.encode("utf-8")) > 47:
            raise FormatError(f"tensor name too long (max 47 bytes): {name}")
        arr = np.ascontiguousarray(values, dtype=np.float32)
        if arr.ndim > 4:
            raise FormatError(f"tensor rank {arr.ndim} > 4 unsupported: {name}")
        self._tensors.append((name, arr))

    def set_vocabulary(self, vocab_bytes: bytes) -> None:
        self._vocab_bytes = vocab_bytes
        self.header.has_vocab = True

    def set_mel_filterbank(self, fb: MelFilterbankData) -> None:
        self._filterbank = fb
        self.header.has_filterbank = True

    def to_bytes(self) -> bytes:
        quant = self.header.quantization
        if quant not in (QUANT_F32, QUANT_F16, QUANT_INT8, QUANT_Q4K,
                         QUANT_Q5K, QUANT_Q6K):
            raise FormatError(
                f"writer supports f32/f16/int8/q4k/q5k/q6k only, got {quant}")
        self.header.n_tensors = len(self._tensors)

        out = bytearray()
        out += MAGIC
        out += self.header.to_bytes()

        # Build payloads and index
        index = bytearray()
        scales = bytearray()
        payload = bytearray()
        offset = 0
        for name, arr in self._tensors:
            shape4 = list(arr.shape) + [0] * (4 - arr.ndim)
            if quant == QUANT_INT8:
                absmax = float(np.max(np.abs(arr))) if arr.size else 0.0
                scale = absmax / 127.0 if absmax > 0 else 1.0
                q = np.clip(np.round(arr / scale), -127, 127).astype(np.int8)
                data = q.tobytes()
                scales += struct.pack("<f", scale)
            elif (quant in _KQUANT_BLOCK_BYTES and arr.ndim == 2
                  and arr.size >= 4096):
                # 2-D matmul weights carry raw k-quant super-blocks over
                # the row-major flat stream, zero-padded to a 256 multiple
                # (matches realizar's element-count rule — the reference's
                # QuantizedTensorQ4K::from_raw only constrains total size,
                # quantized.rs:125-160). When the row length is already a
                # 256 multiple this is identical to per-row quantization.
                # Small/1-D tensors (LN, biases, conv) stay f32.
                flat = np.ascontiguousarray(arr, np.float32).reshape(-1)
                pad = (-flat.size) % 256
                if pad:
                    flat = np.pad(flat, (0, pad))
                data = _kquant_quantize(quant, flat[None]).tobytes()
            elif quant == QUANT_F16:
                data = arr.astype("<f2").tobytes()
            else:
                data = arr.astype("<f4").tobytes()
            desc = TensorDescriptor(
                name=name, offset=offset, size=len(data),
                n_elements=arr.size, shape=tuple(shape4), n_dims=arr.ndim)
            index += desc.to_bytes()
            payload += data
            offset += len(data)

        out += index
        if quant == QUANT_INT8:
            out += scales
        if self.header.compressed:
            from .compress import lz4_frame_compress
            comp = lz4_frame_compress(bytes(payload))
            out += struct.pack("<I", len(comp))
            out += comp
        else:
            out += payload

        if self._vocab_bytes is not None:
            out += struct.pack("<I", len(self._vocab_bytes))
            out += self._vocab_bytes
        if self._filterbank is not None:
            fb_bytes = self._filterbank.to_bytes()
            out += struct.pack("<I", len(fb_bytes))
            out += fb_bytes

        out += struct.pack("<I", crc32(bytes(out)))
        return bytes(out)

    def write_file(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.to_bytes())
