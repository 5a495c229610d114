"""`.apr` model container: reader, writer, validation, CRC32.

Port of ``whisper_apr_tpu/format/`` (v1 container, the v2 JSON-indexed
container and the 25-point validator). Binary-compatible with the JAX
package's files.
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
from .v2 import (MAGIC_V2, AprMetadata, AprReaderV2, AprTensorDescriptor,
                 AprWriterV2, is_v2)
from .validation import AprValidator, TensorStats, ValidationCheck, ValidationReport

__all__ = [
    "AprHeader", "AprReader", "AprWriter", "AprValidator", "Crc32",
    "AprMetadata", "AprReaderV2", "AprWriterV2", "AprTensorDescriptor",
    "MAGIC_V2", "is_v2", "MelFilterbankData", "TensorDescriptor",
    "TensorStats", "ValidationCheck", "ValidationReport", "crc32", "MAGIC",
    "FORMAT_VERSION", "HEADER_SIZE", "TENSOR_INDEX_ENTRY_SIZE", "QUANT_F32", "QUANT_F16", "QUANT_INT8",
    "QUANT_INT4", "QUANT_Q4K", "QUANT_Q5K", "QUANT_Q6K",
]
