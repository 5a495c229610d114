# Copied from whisper_apr_tpu/format/compress.py (host-side numpy, no JAX); keep the two in step.
"""LZ4 block compression (Python) and decompression (the host runtime's C++).

(reference: src/format/compress.rs — pure-Rust LZ4 block decompressor for
WASM, 64 KB blocks, sequence format documented at :1-22: token byte with
literal-length high nibble / match-length-minus-4 low nibble, 15-extension
bytes, 2-byte little-endian match offset, final block must end in literals.)

Host-side only (model files are decompressed once at load).
"""

from __future__ import annotations

import struct
from typing import List

from .. import native
from ..errors import FormatError

BLOCK_SIZE = 64 * 1024            # reference: compress.rs:27
MAX_BLOCK_SIZE = 4 * 1024 * 1024  # reference: compress.rs:30
LZ4_MAGIC = 0x184D2204            # reference: compress.rs:34
MIN_MATCH = 4


def decompress_block(compressed: bytes, decompressed_size: int) -> bytes:
    """Decompress one raw LZ4 block (reference: compress.rs decompress_block)."""
    if decompressed_size > MAX_BLOCK_SIZE:
        raise FormatError(
            f"decompressed size {decompressed_size} exceeds maximum "
            f"{MAX_BLOCK_SIZE}")
    out = _decode_block(compressed, decompressed_size)
    if len(out) != decompressed_size:
        raise FormatError(
            f"LZ4 size mismatch: got {len(out)}, expected {decompressed_size}")
    return out


def _decode_block(compressed: bytes, max_size: int = MAX_BLOCK_SIZE) -> bytes:
    """Decode a raw LZ4 block until the input is consumed (output size may
    be unknown, as in standard LZ4 frames), in the host runtime's C++
    (``native/aprcore.cpp``: the byte loop Python is worst at). On a
    malformed block the Python decoder runs only to raise the exact
    ``FormatError``."""
    out = native.lz4_decompress_block(compressed, max_size)
    if out is not None:
        return out
    return native.lz4_decompress_block_plain(compressed, max_size)


def compress_block(data: bytes) -> bytes:
    """Greedy hash-table LZ4 block compressor (valid block format; not
    ratio-optimal). The last sequence is always literal-only and the final
    5 bytes are literals, per the LZ4 spec."""
    n = len(data)
    if n == 0:
        return b"\x00"
    out = bytearray()
    table: dict = {}
    anchor = 0
    i = 0
    # matches may not start within the last 12 bytes (spec end constraints)
    limit = max(0, n - 12)

    def emit(lit_start: int, lit_end: int, match_off: int = 0,
             match_len: int = 0) -> None:
        lit_len = lit_end - lit_start
        tok_lit = 15 if lit_len >= 15 else lit_len
        tok_match = 0
        if match_len:
            m = match_len - MIN_MATCH
            tok_match = 15 if m >= 15 else m
        out.append((tok_lit << 4) | tok_match)
        if lit_len >= 15:
            rem = lit_len - 15
            while rem >= 255:
                out.append(255)
                rem -= 255
            out.append(rem)
        out.extend(data[lit_start:lit_end])
        if match_len:
            out.append(match_off & 0xFF)
            out.append((match_off >> 8) & 0xFF)
            m = match_len - MIN_MATCH
            if m >= 15:
                rem = m - 15
                while rem >= 255:
                    out.append(255)
                    rem -= 255
                out.append(rem)

    while i < limit:
        key = data[i: i + 4]
        cand = table.get(key)
        table[key] = i
        if cand is not None and i - cand <= 0xFFFF and \
                data[cand: cand + 4] == key:
            # extend the match (but leave the final 5 bytes as literals)
            match_len = 4
            max_len = n - 5 - i
            while match_len < max_len and \
                    data[cand + match_len] == data[i + match_len]:
                match_len += 1
            if match_len >= MIN_MATCH:
                emit(anchor, i, i - cand, match_len)
                i += match_len
                anchor = i
                continue
        i += 1
    # trailing literals
    emit(anchor, n)
    return bytes(out)


class Decompressor:
    """Streaming block decompressor (reference: compress.rs:37 Decompressor)."""

    def __init__(self) -> None:
        self._buffer = b""

    def decompress_block(self, compressed: bytes,
                         decompressed_size: int) -> bytes:
        self._buffer = decompress_block(compressed, decompressed_size)
        return self._buffer


def compress_blocks(data: bytes, block_size: int = BLOCK_SIZE) -> bytes:
    """Split into blocks and compress each: u32 compressed-size + u32
    original-size + payload per block (the framing the .apr ``compressed``
    flag implies — 64 KB blocks, reference: compress.rs:27)."""
    out = bytearray()
    for start in range(0, len(data), block_size):
        chunk = data[start: start + block_size]
        comp = compress_block(chunk)
        out += struct.pack("<II", len(comp), len(chunk))
        out += comp
    return bytes(out)


def decompress_blocks(data: bytes) -> bytes:
    """Inverse of compress_blocks."""
    out = bytearray()
    i = 0
    while i < len(data):
        if i + 8 > len(data):
            raise FormatError("truncated compressed block header")
        comp_size, orig_size = struct.unpack_from("<II", data, i)
        i += 8
        if i + comp_size > len(data):
            raise FormatError("truncated compressed block payload")
        out += decompress_block(data[i: i + comp_size], orig_size)
        i += comp_size
    return bytes(out)


# ---------------------------------------------------------------------------
# Standard LZ4 FRAME format (spec v1.6.1) — interchange-compatible with the
# lz4 CLI and any conforming reader. The reference only detects the frame
# magic (compress.rs:34 LZ4_MAGIC); this implements the full framing so
# compressed .apr payloads are standard LZ4 frames, not a private layout.
# ---------------------------------------------------------------------------

_XXH_P1, _XXH_P2, _XXH_P3 = 2654435761, 2246822519, 3266489917
_XXH_P4, _XXH_P5 = 668265263, 374761393
_M32 = 0xFFFFFFFF


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def xxh32(data: bytes, seed: int = 0) -> int:
    """xxHash32 (needed for LZ4 frame header/content checksums)."""
    n = len(data)
    i = 0
    if n >= 16:
        v1 = (seed + _XXH_P1 + _XXH_P2) & _M32
        v2 = (seed + _XXH_P2) & _M32
        v3 = seed & _M32
        v4 = (seed - _XXH_P1) & _M32
        while i <= n - 16:
            for idx, v in enumerate((v1, v2, v3, v4)):
                (lane,) = struct.unpack_from("<I", data, i + 4 * idx)
                v = (v + lane * _XXH_P2) & _M32
                v = _rotl32(v, 13)
                v = (v * _XXH_P1) & _M32
                if idx == 0:
                    v1 = v
                elif idx == 1:
                    v2 = v
                elif idx == 2:
                    v3 = v
                else:
                    v4 = v
            i += 16
        h = (_rotl32(v1, 1) + _rotl32(v2, 7) + _rotl32(v3, 12)
             + _rotl32(v4, 18)) & _M32
    else:
        h = (seed + _XXH_P5) & _M32
    h = (h + n) & _M32
    while i <= n - 4:
        (lane,) = struct.unpack_from("<I", data, i)
        h = (h + lane * _XXH_P3) & _M32
        h = (_rotl32(h, 17) * _XXH_P4) & _M32
        i += 4
    while i < n:
        h = (h + data[i] * _XXH_P5) & _M32
        h = (_rotl32(h, 11) * _XXH_P1) & _M32
        i += 1
    h ^= h >> 15
    h = (h * _XXH_P2) & _M32
    h ^= h >> 13
    h = (h * _XXH_P3) & _M32
    h ^= h >> 16
    return h


def lz4_frame_compress(data: bytes, block_size: int = BLOCK_SIZE) -> bytes:
    """Standard LZ4 frame: magic, descriptor (independent 64 KB blocks,
    content size present), blocks (stored uncompressed when compression
    does not help, per spec), end mark."""
    out = bytearray()
    out += struct.pack("<I", LZ4_MAGIC)
    flg = 0x40 | 0x20 | 0x08  # version=01, B.Indep=1, C.Size=1
    bd = 0x40                 # block max size code 4 = 64 KB
    desc = bytes([flg, bd]) + struct.pack("<Q", len(data))
    hc = (xxh32(desc) >> 8) & 0xFF
    out += desc + bytes([hc])
    for start in range(0, len(data), block_size):
        chunk = data[start: start + block_size]
        comp = compress_block(chunk)
        if len(comp) < len(chunk):
            out += struct.pack("<I", len(comp))
            out += comp
        else:  # incompressible: stored block (high bit set)
            out += struct.pack("<I", len(chunk) | 0x80000000)
            out += chunk
    out += struct.pack("<I", 0)  # end mark
    return bytes(out)


def lz4_frame_decompress(data: bytes) -> bytes:
    """Parse a standard LZ4 frame (any conforming writer's output)."""
    if len(data) < 7:
        raise FormatError("truncated LZ4 frame")
    (magic,) = struct.unpack_from("<I", data, 0)
    if magic != LZ4_MAGIC:
        raise FormatError(f"bad LZ4 frame magic {magic:#x}")
    i = 4
    flg, bd = data[i], data[i + 1]
    if (flg >> 6) != 0b01:
        raise FormatError("unsupported LZ4 frame version")
    has_bchk = bool(flg & 0x10)
    has_csize = bool(flg & 0x08)
    has_cchk = bool(flg & 0x04)
    has_dict = bool(flg & 0x01)
    desc_len = 2 + (8 if has_csize else 0) + (4 if has_dict else 0)
    desc = data[i: i + desc_len]
    hc = data[i + desc_len]
    if hc != ((xxh32(desc) >> 8) & 0xFF):
        raise FormatError("LZ4 frame header checksum mismatch")
    content_size = struct.unpack_from("<Q", data, i + 2)[0] if has_csize else None
    i += desc_len + 1
    bmax = {4: 64 << 10, 5: 256 << 10, 6: 1 << 20, 7: 4 << 20}.get(
        (bd >> 4) & 0x7)
    if bmax is None:
        raise FormatError("invalid LZ4 frame block size code")
    out = bytearray()
    while True:
        if i + 4 > len(data):
            raise FormatError("truncated LZ4 frame block header")
        (word,) = struct.unpack_from("<I", data, i)
        i += 4
        if word == 0:
            break  # end mark
        stored = bool(word & 0x80000000)
        size = word & 0x7FFFFFFF
        if i + size > len(data):
            raise FormatError("truncated LZ4 frame block")
        block = data[i: i + size]
        i += size
        if has_bchk:
            if i + 4 > len(data):
                raise FormatError("truncated LZ4 block checksum")
            (bchk,) = struct.unpack_from("<I", data, i)
            i += 4
            if bchk != xxh32(block):
                raise FormatError("LZ4 block checksum mismatch")
        out += block if stored else _decode_block(block, bmax)
    if has_cchk:
        if i + 4 > len(data):
            raise FormatError("truncated LZ4 content checksum")
        (cchk,) = struct.unpack_from("<I", data, i)
        if cchk != xxh32(bytes(out)):
            raise FormatError("LZ4 content checksum mismatch")
    if content_size is not None and len(out) != content_size:
        raise FormatError(
            f"LZ4 content size mismatch: {len(out)} != {content_size}")
    return bytes(out)
