"""TFRecord files without TensorFlow (counterpart of the JAX package's
``data/native_io.py``: its ``_py_tfrecord_iter`` and ``masked_crc32c``).

A TFRecord file is a run of records, each framed as

    uint64 length (little endian)
    uint32 masked crc32c of those 8 bytes
    bytes  payload[length]
    uint32 masked crc32c of the payload

crc32c is CRC-32 with the Castagnoli polynomial (reflected 0x82F63B78),
and the mask is ``((crc >> 15) | (crc << 17)) + 0xA282EAD8`` mod 2^32.

crc32c runs in numpy, with no loop over bytes in Python: the payload is
cut into up to 32768 chunks of equal length, whose raw CRC registers
(started at 0) are stepped through one table lookup per byte in lockstep,
one numpy operation per byte position over all chunks. The chunks' registers
are then folded pairwise: the register of A||B is the register of A shifted
through |B| zero bytes, XOR that of B. A shift through n zero bytes is a
linear map on 32 bits, applied as four 256-entry tables and built by
squaring the one-byte shift.

A record whose length or payload does not match its crc raises
``ValueError`` with the file and the record's offset, as tf.data's reader
raises (the JAX package's native reader skips such a record instead).
"""

from __future__ import annotations

import functools
import os
import struct
from typing import Iterable, Iterator

import numpy as np

POLY = 0x82F63B78  # crc32c, reflected
MASK_DELTA = 0xA282EAD8
MAX_CHUNKS = 32768
MIN_CHUNK = 64  # bytes per lockstep chunk below which fewer chunks are used


def _byte_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(POLY), t >> 1).astype(np.uint32)
    return t


TABLE = _byte_table()
_BITS = ((np.arange(256)[:, None] >> np.arange(8)) & 1).astype(bool)  # [value, bit]


def _tables(columns: np.ndarray) -> np.ndarray:
    """[4, 256] lookup tables of the linear map whose image of bit i is
    ``columns[i]``: map(x) = T0[x & 255] ^ T1[x >> 8 & 255] ^ ..."""
    cols = columns.reshape(4, 1, 8)
    return np.bitwise_xor.reduce(np.where(_BITS[None], cols, np.uint32(0)), axis=2).astype(np.uint32)


def _apply(tables: np.ndarray, x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.uint32)
    return (tables[0][x & 255] ^ tables[1][(x >> 8) & 255] ^ tables[2][(x >> 16) & 255]
            ^ tables[3][x >> 24]).astype(np.uint32)


_UNIT = (np.uint32(1) << np.arange(32, dtype=np.uint32)).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _shift_pow2(log2_bytes: int) -> np.ndarray:
    """Tables of the shift of a raw register through 2^log2_bytes zero
    bytes, by squaring the one-byte shift."""
    if log2_bytes == 0:
        return _tables((TABLE[_UNIT & 255] ^ (_UNIT >> 8)).astype(np.uint32))
    half = _shift_pow2(log2_bytes - 1)
    return _tables(_apply(half, _apply(half, _UNIT)))


def _shift(nbytes: int) -> np.ndarray:
    """Tables of the shift through ``nbytes`` zero bytes, composed from the
    cached powers of two."""
    cols, bit = _UNIT, 0
    while nbytes:
        if nbytes & 1:
            cols = _apply(_shift_pow2(bit), cols)
        nbytes >>= 1
        bit += 1
    return _tables(cols)


def _raw_crc(data: np.ndarray) -> int:
    """The CRC register after ``data`` from a register of 0 (no pre- or
    post-inversion). Chunk length and count are powers of two, so that the
    fold takes only cached shifts."""
    n = data.size
    if n == 0:
        return 0
    length = MIN_CHUNK
    while length * MAX_CHUNKS < n:
        length *= 2
    chunks = 1
    while chunks * length < n:
        chunks *= 2
    # leading zero bytes leave a register of 0 at 0: pad in front
    padded = np.zeros(chunks * length, np.uint8)
    padded[chunks * length - n:] = data
    columns = np.ascontiguousarray(padded.reshape(chunks, length).T)  # [byte position, chunk]
    reg, index = np.zeros(chunks, np.uint32), np.empty(chunks, np.uint32)
    for i in range(length - min(length, n), length):  # a lone short chunk's leading zeros change nothing
        np.bitwise_xor(reg, columns[i], out=index)
        np.bitwise_and(index, 255, out=index)
        np.right_shift(reg, 8, out=reg)
        np.bitwise_xor(reg, TABLE[index], out=reg)
    level = length.bit_length() - 1
    while reg.size > 1:
        reg = _apply(_shift_pow2(level), reg[0::2]) ^ reg[1::2]
        level += 1
    return int(reg[0])


def crc32c(data) -> int:
    """crc32c (Castagnoli) of ``data``: bytes, bytearray, memoryview or a
    uint8 array. The standard register starts at ~0: its effect is that
    start shifted through the data, XOR the raw register from 0."""
    buf = data.reshape(-1).view(np.uint8) if isinstance(data, np.ndarray) else np.frombuffer(data, np.uint8)
    start = int(_apply(_shift(buf.size), np.uint32(0xFFFFFFFF)))
    return (start ^ _raw_crc(buf)) ^ 0xFFFFFFFF


def masked_crc32c(data) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + MASK_DELTA) & 0xFFFFFFFF


def frame(payload: bytes) -> bytes:
    """One record as it is written to a TFRecord file."""
    header = struct.pack("<Q", len(payload))
    return b"".join((header, struct.pack("<I", masked_crc32c(header)), payload,
                     struct.pack("<I", masked_crc32c(payload))))


def read_records(path: str) -> Iterator[bytes]:
    """The payloads of the TFRecord file at ``path``, in order, each crc
    checked; a corrupt or truncated record raises ``ValueError`` naming the
    file and the record's offset."""
    with open(path, "rb") as f:
        data = f.read()
    offset, end = 0, len(data)
    while offset < end:
        if end - offset < 12:
            raise ValueError(f"{path}: truncated record header at offset {offset}")
        header = data[offset:offset + 8]
        (length,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack("<I", data[offset + 8:offset + 12])
        if crc != masked_crc32c(header):
            raise ValueError(f"{path}: corrupt record length at offset {offset}")
        start = offset + 12
        if end - start < length + 4:
            raise ValueError(f"{path}: truncated record at offset {offset}")
        payload = data[start:start + length]
        (crc,) = struct.unpack("<I", data[start + length:start + length + 4])
        if crc != masked_crc32c(payload):
            raise ValueError(f"{path}: corrupt record at offset {offset} (payload crc32c mismatch)")
        yield payload
        offset = start + length + 4


def iter_records(paths: Iterable[str]) -> Iterator[bytes]:
    """The records of several files, file after file in the given order."""
    for path in paths:
        yield from read_records(os.fspath(path))


class TFRecordWriter:
    """Writes framed records to ``path``; a context manager like
    ``tf.io.TFRecordWriter``."""

    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, payload: bytes) -> None:
        self._f.write(frame(bytes(payload)))

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "TFRecordWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
