"""The ``tf.train.Example`` wire format, read and written by hand (the JAX
package's ``data/rlds.py`` goes through ``tf.io.parse_single_example`` and
``tf.train.Example``).

    message Example  { Features features = 1; }
    message Features { map<string, Feature> feature = 1; }
    message Feature  { oneof kind { BytesList bytes_list = 1;
                                    FloatList float_list = 2;
                                    Int64List int64_list = 3; } }
    message BytesList { repeated bytes value = 1; }
    message FloatList { repeated float value = 1 [packed = true]; }
    message Int64List { repeated int64 value = 1 [packed = true]; }

A feature is ``(kind, values)``: ``("bytes", [bytes, ...])``,
``("float", float32 array)`` or ``("int64", int64 array)``. The reader
takes packed and unpacked lists alike and skips unknown fields; packed
floats are one ``np.frombuffer``, packed varints are decoded in numpy. The
writer packs both numeric lists, as TensorFlow does.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

BYTES, FLOAT, INT64 = "bytes", "float", "int64"
_KINDS = {1: BYTES, 2: FLOAT, 3: INT64}
_FIELDS = {v: k for k, v in _KINDS.items()}


def _varint(buf, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("malformed varint")


def _fields(buf, start: int, end: int):
    """(field number, wire type, value) of a message's fields: the value is
    an int for varints, else a (start, end) span of ``buf``."""
    pos = start
    while pos < end:
        key, pos = _varint(buf, pos)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value, pos = (pos, pos + n), pos + n
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            value, pos = (pos, pos + n), pos + n
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        if pos > end:
            raise ValueError("truncated protobuf message")
        yield number, wire, value


def decode_varints(data: np.ndarray) -> np.ndarray:
    """Packed varints (uint8 array) -> int64 array, without a loop per value."""
    if data.size == 0:
        return np.zeros(0, np.int64)
    if data[-1] >= 0x80:
        raise ValueError("truncated packed varint")
    ends = np.flatnonzero(data < 0x80)
    starts = np.concatenate(([0], ends[:-1] + 1))
    lengths = ends - starts + 1
    if lengths.max() > 10:
        raise ValueError("malformed packed varint")
    position = np.arange(data.size) - np.repeat(starts, lengths)
    groups = (data & 0x7F).astype(np.uint64) << (7 * position).astype(np.uint64)
    return np.bitwise_or.reduceat(groups, starts).view(np.int64)


def encode_varints(values: np.ndarray) -> bytes:
    """int64 array -> packed varints (two's complement: a negative value
    takes 10 bytes), without a loop per value."""
    v = np.asarray(values, np.int64).reshape(-1).view(np.uint64)
    shifts = (7 * np.arange(10)).astype(np.uint64)
    groups = ((v[:, None] >> shifts) & np.uint64(0x7F)).astype(np.uint8)
    n = 1 + ((v[:, None] >> shifts[1:]) != 0).sum(1)
    cont = np.arange(10) < (n[:, None] - 1)
    groups |= np.where(cont, 0x80, 0).astype(np.uint8)
    return groups[np.arange(10) < n[:, None]].tobytes()


def _varint_bytes(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _len_field(number: int, payload: bytes) -> bytes:
    return _varint_bytes(number << 3 | 2) + _varint_bytes(len(payload)) + payload


def _parse_feature(buf, start: int, end: int) -> Tuple[str, object]:
    kind, parts = None, []
    for number, wire, value in _fields(buf, start, end):
        if number not in _KINDS or wire != 2:
            continue
        kind, parts = _KINDS[number], []  # a oneof: the last kind set wins
        for n, w, v in _fields(buf, *value):
            if n != 1:
                continue
            if kind == BYTES:
                parts.append(bytes(buf[v[0]:v[1]]))
            elif kind == FLOAT:
                parts.append(np.frombuffer(buf[v[0]:v[1]], "<f4"))
            elif w == 0:
                parts.append(np.asarray([v], np.uint64).view(np.int64))
            else:
                parts.append(decode_varints(np.frombuffer(buf[v[0]:v[1]], np.uint8)))
    if kind is None:
        return BYTES, []  # an empty Feature: no kind set
    if kind == BYTES:
        return BYTES, parts
    dtype = np.float32 if kind == FLOAT else np.int64
    return kind, np.concatenate(parts).astype(dtype, copy=False) if parts else np.zeros(0, dtype)


def parse_example(serialized: bytes) -> Dict[str, Tuple[str, object]]:
    """A serialized ``tf.train.Example`` -> {key: (kind, values)}."""
    buf = memoryview(serialized)
    out: Dict[str, Tuple[str, object]] = {}
    for number, wire, span in _fields(buf, 0, len(buf)):
        if number != 1 or wire != 2:
            continue
        for n, w, entry in _fields(buf, *span):
            if n != 1 or w != 2:
                continue
            key, feature = "", (BYTES, [])
            for en, ew, ev in _fields(buf, *entry):
                if en == 1 and ew == 2:
                    key = bytes(buf[ev[0]:ev[1]]).decode("utf-8")
                elif en == 2 and ew == 2:
                    feature = _parse_feature(buf, *ev)
            out[key] = feature  # a map: the last entry of a key wins
    return out


def serialize_example(features: Dict[str, Tuple[str, object]]) -> bytes:
    """{key: (kind, values)} -> a serialized ``tf.train.Example``."""
    entries: List[bytes] = []
    for key, (kind, values) in features.items():
        if kind == BYTES:
            body = b"".join(_len_field(1, bytes(v)) for v in values)
        elif kind == FLOAT:
            data = np.asarray(values, "<f4").reshape(-1).tobytes()
            body = _len_field(1, data) if data else b""
        elif kind == INT64:
            data = encode_varints(values)
            body = _len_field(1, data) if data else b""
        else:
            raise ValueError(f"unknown feature kind {kind!r}")
        feature = _len_field(_FIELDS[kind], body)
        entries.append(_len_field(1, _len_field(1, key.encode("utf-8")) + _len_field(2, feature)))
    return _len_field(1, b"".join(entries))
