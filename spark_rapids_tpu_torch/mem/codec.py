"""Byte codecs for spilled batches and the chunked disk frames (port of
``spark_rapids_tpu/mem/codec.py``; the codec is
``spark.rapids.shuffle.compression.codec``).  A frame file written here
is byte for byte the JAX package's for the same bytes, codec and chunk
size.  ``nativelz`` (the JAX package's C++ block codec) is not ported."""

from __future__ import annotations

import struct
import zlib
from typing import BinaryIO, Callable, Dict


class Codec:
    name = "copy"

    def compress(self, data: bytes) -> bytes:
        return data

    def decompress(self, data: bytes, uncompressed_size: int) -> bytes:
        return data


class CopyCodec(Codec):
    name = "copy"


class ZlibCodec(Codec):
    name = "zlib"

    def __init__(self, level: int = 1):
        self.level = level

    def compress(self, data: bytes) -> bytes:
        return zlib.compress(data, self.level)

    def decompress(self, data: bytes, uncompressed_size: int) -> bytes:
        return zlib.decompress(data)


_CODECS: Dict[str, Callable[[], Codec]] = {
    "copy": CopyCodec,
    "uncompressed": CopyCodec,
    "zlib": ZlibCodec,
}


def get_codec(name: str) -> Codec:
    key = name.lower()
    if key == "nativelz" and key not in _CODECS:
        raise ValueError("the nativelz codec needs the native host runtime "
                         "(native/batch_runtime.cc), which the port does "
                         "not have yet (ROADMAP.md queue 1, item 10)")
    try:
        return _CODECS[key]()
    except KeyError:
        raise ValueError(f"unknown compression codec: {name}") from None


def register_codec(name: str, factory: Callable[[], Codec]):
    _CODECS[name.lower()] = factory


# A spill file is a sequence of independently compressed frames, so
# compression overlaps the file write and unspill decompresses frame i
# while frame i+1 is read:
#
#     header:   "<QQ"  total_raw_len, frame_count
#     frame i:  "<QQ"  raw_len, enc_len   then enc_len codec bytes
#
# chunk_bytes <= 0 writes one whole-batch frame.

_FRAME_HEADER = struct.Struct("<QQ")


def write_chunked(f: BinaryIO, data: bytes, codec: Codec,
                  chunk_bytes: int) -> int:
    """Stream ``data`` through ``codec`` into ``f`` in frames of
    ``chunk_bytes``; returns the encoded bytes (headers excluded)."""
    step = max(1, len(data)) if chunk_bytes <= 0 else max(1, int(chunk_bytes))
    n = max(1, -(-len(data) // step)) if data else 1
    f.write(_FRAME_HEADER.pack(len(data), n))
    view = memoryview(data)
    enc_total = 0
    for off in range(0, len(data) or 1, step):
        raw = view[off:off + step]
        enc = codec.compress(raw)
        f.write(_FRAME_HEADER.pack(len(raw), len(enc)))
        f.write(enc)
        enc_total += len(enc)
    return enc_total


def read_chunked(f: BinaryIO, codec: Codec) -> bytes:
    """The reverse of :func:`write_chunked`."""
    total_raw, n = _FRAME_HEADER.unpack(f.read(_FRAME_HEADER.size))
    parts = []
    got = 0
    for _ in range(n):
        raw_len, enc_len = _FRAME_HEADER.unpack(f.read(_FRAME_HEADER.size))
        enc = f.read(enc_len)
        if len(enc) != enc_len:
            raise ValueError("truncated spill frame")
        parts.append(codec.decompress(enc, raw_len))
        got += raw_len
    if got != total_raw:
        raise ValueError(
            f"spill frame total {got} != header raw length {total_raw}")
    return b"".join(parts)
