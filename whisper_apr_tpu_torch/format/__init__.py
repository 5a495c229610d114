"""`.apr` model container (v1): reader, writer, CRC32.

Port of ``whisper_apr_tpu/format/`` without ``v2.py`` and ``validation.py``
(later slices). Binary-compatible with the JAX package's files.
"""

from .checksum import Crc32, crc32
from .container import (
    FORMAT_VERSION,
    HEADER_SIZE,
    MAGIC,
    QUANT_F16,
    QUANT_F32,
    QUANT_INT4,
    QUANT_INT8,
    QUANT_Q4K,
    QUANT_Q5K,
    QUANT_Q6K,
    TENSOR_INDEX_ENTRY_SIZE,
    AprHeader,
    AprReader,
    AprWriter,
    MelFilterbankData,
    TensorDescriptor,
)

__all__ = [
    "AprHeader", "AprReader", "AprWriter", "Crc32", "MelFilterbankData",
    "TensorDescriptor", "crc32", "MAGIC", "FORMAT_VERSION", "HEADER_SIZE",
    "TENSOR_INDEX_ENTRY_SIZE", "QUANT_F32", "QUANT_F16", "QUANT_INT8",
    "QUANT_INT4", "QUANT_Q4K", "QUANT_Q5K", "QUANT_Q6K",
]
