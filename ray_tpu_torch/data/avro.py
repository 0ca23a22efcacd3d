"""Minimal Avro object-container-file reader (no external deps).

Reference: `python/ray/data/_internal/datasource/avro_datasource.py`
(which wraps the `fastavro` package).  This is a native decoder for the
common subset: container files with `null` or `deflate` codecs, and
schemas composed of primitives, records, arrays, maps, unions, enums,
and fixed — enough for the files data pipelines actually exchange.

Format (Avro 1.11 spec): header `Obj\x01` + metadata map (schema JSON,
codec) + 16-byte sync marker, then blocks of
`<count><byte-size><records><sync>` with zigzag-varint framing.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Any, Dict, List, Tuple

MAGIC = b"Obj\x01"


class _Reader:
    def __init__(self, data: bytes):
        self.buf = data
        self.pos = 0

    def read(self, n: int) -> bytes:
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated avro data")
        self.pos += n
        return out

    def at_end(self) -> bool:
        return self.pos >= len(self.buf)

    # -- primitives -----------------------------------------------------
    def long(self) -> int:
        shift = 0
        acc = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            acc |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)  # zigzag

    def bytes_(self) -> bytes:
        return self.read(self.long())

    def string(self) -> str:
        return self.bytes_().decode()

    def float_(self) -> float:
        return struct.unpack("<f", self.read(4))[0]

    def double(self) -> float:
        return struct.unpack("<d", self.read(8))[0]

    def boolean(self) -> bool:
        return self.read(1) != b"\x00"


def _decode(r: _Reader, schema: Any, named: Dict[str, Any]) -> Any:
    if isinstance(schema, str):
        s = schema
        if s == "null":
            return None
        if s == "boolean":
            return r.boolean()
        if s in ("int", "long"):
            return r.long()
        if s == "float":
            return r.float_()
        if s == "double":
            return r.double()
        if s == "bytes":
            return r.bytes_()
        if s == "string":
            return r.string()
        if s in named:  # named-type reference
            return _decode(r, named[s], named)
        raise ValueError(f"unsupported avro type {s!r}")
    if isinstance(schema, list):  # union: branch index then value
        return _decode(r, schema[r.long()], named)
    t = schema["type"]
    if t == "record":
        named[schema["name"]] = schema
        return {
            f["name"]: _decode(r, f["type"], named)
            for f in schema["fields"]
        }
    if t == "array":
        out: List[Any] = []
        while True:
            n = r.long()
            if n == 0:
                return out
            if n < 0:  # block with byte size
                n = -n
                r.long()
            for _ in range(n):
                out.append(_decode(r, schema["items"], named))
    if t == "map":
        m: Dict[str, Any] = {}
        while True:
            n = r.long()
            if n == 0:
                return m
            if n < 0:
                n = -n
                r.long()
            for _ in range(n):
                m[r.string()] = _decode(r, schema["values"], named)
    if t == "enum":
        named[schema["name"]] = schema
        return schema["symbols"][r.long()]
    if t == "fixed":
        named[schema["name"]] = schema
        return r.read(schema["size"])
    # {"type": "string"} style wrappers
    if isinstance(t, (str, list, dict)):
        return _decode(r, t, named)
    raise ValueError(f"unsupported avro schema {schema!r}")


def read_avro_rows(path: str) -> List[Dict[str, Any]]:
    with open(path, "rb") as f:
        data = f.read()
    r = _Reader(data)
    if r.read(4) != MAGIC:
        raise ValueError(f"{path} is not an avro container file")
    meta: Dict[str, bytes] = {}
    while True:
        n = r.long()
        if n == 0:
            break
        if n < 0:
            n = -n
            r.long()
        for _ in range(n):
            key = r.string()
            meta[key] = r.bytes_()
    schema = json.loads(meta["avro.schema"])
    codec = meta.get("avro.codec", b"null").decode()
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported avro codec {codec!r}")
    sync = r.read(16)
    rows: List[Dict[str, Any]] = []
    named: Dict[str, Any] = {}
    while not r.at_end():
        count = r.long()
        size = r.long()
        payload = r.read(size)
        if codec == "deflate":
            payload = zlib.decompress(payload, -15)
        br = _Reader(payload)
        for _ in range(count):
            row = _decode(br, schema, named)
            rows.append(row if isinstance(row, dict) else {"value": row})
        if r.read(16) != sync:
            raise ValueError(f"avro sync marker mismatch in {path}")
    return rows
