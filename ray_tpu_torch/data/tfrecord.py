"""TFRecord IO without a TensorFlow dependency.

Reference: `python/ray/data/_internal/datasource/tfrecords_datasource.py`
(which imports TensorFlow for both the record framing and the
`tf.Example` proto).  TFRecord is *the* canonical TPU training input
format, so this framework ships a native implementation of both layers:

- **record framing**: `<u64 length><u32 masked-crc32c(length)>
  <data><u32 masked-crc32c(data)>` per record;
- **tf.Example**: a tiny protobuf wire-format codec for the fixed
  Example/Features/Feature schema (bytes_list / float_list /
  int64_list) — the schema is frozen upstream, so a general proto
  runtime is unnecessary.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List, Union

import numpy as np

# ---------------------------------------------------------------------------
# crc32c (Castagnoli), masked per the TFRecord spec.  The native
# `google_crc32c` extension is used when importable (it ships with the
# google-cloud stack); the fallback is a slice-by-8 table walk in plain
# python ints — a per-byte numpy-scalar loop would make checksum
# verification slower than the file IO it protects.
# ---------------------------------------------------------------------------
try:
    import google_crc32c as _gcrc
except ImportError:  # pragma: no cover - present in the image
    _gcrc = None

_CRC_TABLES = None


def _crc_tables():
    global _CRC_TABLES
    if _CRC_TABLES is None:
        poly = 0x82F63B78
        t0 = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            t0.append(c)
        tables = [t0]
        for k in range(1, 8):
            prev = tables[k - 1]
            tables.append([t0[v & 0xFF] ^ (v >> 8) for v in prev])
        _CRC_TABLES = tables
    return _CRC_TABLES


def crc32c(data: bytes) -> int:
    if _gcrc is not None:
        return int(_gcrc.value(bytes(data)))
    t = _crc_tables()
    crc = 0xFFFFFFFF
    n = len(data)
    i = 0
    while n - i >= 8:
        low = crc ^ int.from_bytes(data[i:i + 4], "little")
        hi = int.from_bytes(data[i + 4:i + 8], "little")
        crc = (
            t[7][low & 0xFF] ^ t[6][(low >> 8) & 0xFF]
            ^ t[5][(low >> 16) & 0xFF] ^ t[4][low >> 24]
            ^ t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF]
            ^ t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24]
        )
        i += 8
    t0 = t[0]
    for b in data[i:]:
        crc = t0[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# record framing
# ---------------------------------------------------------------------------
def write_records(path: str, records: List[bytes]) -> None:
    with open(path, "wb") as f:
        for rec in records:
            header = struct.pack("<Q", len(rec))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(rec)
            f.write(struct.pack("<I", _masked_crc(rec)))


def read_records(path: str, *, verify: bool = True) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                return
            if len(header) != 8:
                raise ValueError(f"truncated TFRecord header in {path}")
            (length,) = struct.unpack("<Q", header)
            hcrc_raw = f.read(4)
            if len(hcrc_raw) != 4:
                raise ValueError(f"truncated TFRecord header crc in {path}")
            (hcrc,) = struct.unpack("<I", hcrc_raw)
            data = f.read(length)
            if len(data) != length:
                raise ValueError(f"truncated TFRecord data in {path}")
            dcrc_raw = f.read(4)
            if len(dcrc_raw) != 4:
                raise ValueError(f"truncated TFRecord data crc in {path}")
            (dcrc,) = struct.unpack("<I", dcrc_raw)
            if verify:
                if _masked_crc(header) != hcrc:
                    raise ValueError(f"TFRecord length crc mismatch in {path}")
                if _masked_crc(data) != dcrc:
                    raise ValueError(f"TFRecord data crc mismatch in {path}")
            yield data


# ---------------------------------------------------------------------------
# minimal protobuf wire codec for tf.Example
#
# message Example { Features features = 1; }
# message Features { map<string, Feature> feature = 1; }
# message Feature { oneof kind {
#     BytesList bytes_list = 1; FloatList float_list = 2;
#     Int64List int64_list = 3; } }
# message BytesList { repeated bytes value = 1; }
# message FloatList { repeated float value = 1 [packed=true]; }
# message Int64List { repeated int64 value = 1 [packed=true]; }
# ---------------------------------------------------------------------------
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: memoryview, pos: int):
    shift = 0
    result = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _len_delimited(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def _encode_feature(values) -> bytes:
    if isinstance(values, (bytes, str)):
        values = [values]
    elif isinstance(values, np.ndarray):
        values = values.tolist()
    elif not isinstance(values, (list, tuple)):
        values = [values]
    if not values:
        return _len_delimited(1, b"")  # empty bytes_list
    v0 = values[0]
    if isinstance(v0, (bytes, str)):
        inner = b"".join(
            _len_delimited(1, v.encode() if isinstance(v, str) else v)
            for v in values
        )
        return _len_delimited(1, inner)  # bytes_list
    if isinstance(v0, (float, np.floating)):
        packed = struct.pack(f"<{len(values)}f", *[float(v) for v in values])
        return _len_delimited(2, _len_delimited(1, packed))
    if isinstance(v0, (int, np.integer)):
        packed = b"".join(_varint(int(v) & (1 << 64) - 1) for v in values)
        return _len_delimited(3, _len_delimited(1, packed))
    raise TypeError(f"unsupported feature value type {type(v0).__name__}")


def encode_example(features: Dict[str, Any]) -> bytes:
    """{name: bytes|str|int|float|list-thereof} -> serialized Example."""
    feats = bytearray()
    for name, values in features.items():
        key = _len_delimited(1, name.encode())
        val = _len_delimited(2, _encode_feature(values))
        feats += _len_delimited(1, key + val)
    return _len_delimited(1, bytes(feats))


def _decode_feature(buf: memoryview):
    """Feature message -> python list (bytes / float / int)."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire != 2:
            raise ValueError(f"unexpected wire type {wire} in Feature")
        ln, pos = _read_varint(buf, pos)
        inner = buf[pos:pos + ln]
        pos += ln
        if field == 1:  # BytesList
            out: List[Any] = []
            ip = 0
            while ip < len(inner):
                t, ip = _read_varint(inner, ip)
                if t != (1 << 3 | 2):
                    raise ValueError("bad BytesList")
                n, ip = _read_varint(inner, ip)
                out.append(bytes(inner[ip:ip + n]))
                ip += n
            return out
        if field == 2:  # FloatList (packed or repeated)
            out = []
            ip = 0
            while ip < len(inner):
                t, ip = _read_varint(inner, ip)
                if t == (1 << 3 | 2):  # packed
                    n, ip = _read_varint(inner, ip)
                    out.extend(struct.unpack(f"<{n // 4}f",
                                             bytes(inner[ip:ip + n])))
                    ip += n
                elif t == (1 << 3 | 5):  # single fixed32
                    out.extend(struct.unpack("<f", bytes(inner[ip:ip + 4])))
                    ip += 4
                else:
                    raise ValueError("bad FloatList")
            return [float(v) for v in out]
        if field == 3:  # Int64List (packed or repeated varint)
            out = []
            ip = 0
            while ip < len(inner):
                t, ip = _read_varint(inner, ip)
                if t == (1 << 3 | 2):  # packed
                    n, ip = _read_varint(inner, ip)
                    end = ip + n
                    while ip < end:
                        v, ip = _read_varint(inner, ip)
                        out.append(v - (1 << 64) if v >= 1 << 63 else v)
                elif t == (1 << 3 | 0):
                    v, ip = _read_varint(inner, ip)
                    out.append(v - (1 << 64) if v >= 1 << 63 else v)
                else:
                    raise ValueError("bad Int64List")
            return out
    return []


def decode_example(data: Union[bytes, memoryview]) -> Dict[str, Any]:
    """Serialized Example -> {name: list of bytes/float/int}."""
    buf = memoryview(data)
    pos = 0
    out: Dict[str, Any] = {}
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        if tag != (1 << 3 | 2):  # Example.features
            raise ValueError("not a tf.Example")
        ln, pos = _read_varint(buf, pos)
        feats = buf[pos:pos + ln]
        pos += ln
        fp = 0
        while fp < len(feats):
            t, fp = _read_varint(feats, fp)
            if t != (1 << 3 | 2):  # Features.feature entry
                raise ValueError("bad Features map")
            n, fp = _read_varint(feats, fp)
            entry = feats[fp:fp + n]
            fp += n
            ep = 0
            name = None
            value: Any = []
            while ep < len(entry):
                et, ep = _read_varint(entry, ep)
                en, ep = _read_varint(entry, ep)
                payload = entry[ep:ep + en]
                ep += en
                if et == (1 << 3 | 2):  # key
                    name = bytes(payload).decode()
                elif et == (2 << 3 | 2):  # value: Feature
                    value = _decode_feature(payload)
            if name is not None:
                out[name] = value
    return out


def _scalarize(values):
    """Single-element feature lists become scalars (the shape users
    expect from row-oriented reads)."""
    return values[0] if isinstance(values, list) and len(values) == 1 else values


def read_tfrecords_rows(path: str, *, parse_example: bool = True,
                        verify: bool = True) -> List[Dict[str, Any]]:
    rows = []
    for rec in read_records(path, verify=verify):
        if parse_example:
            try:
                rows.append({
                    k: _scalarize(v) for k, v in decode_example(rec).items()
                })
                continue
            except (ValueError, IndexError, struct.error):
                # not an Example (truncated varints surface as
                # IndexError, bad packed floats as struct.error):
                # surface the raw record instead
                pass
        rows.append({"data": rec})
    return rows
