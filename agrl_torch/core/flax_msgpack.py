"""Read agrl_tpu's `.msgpack` checkpoints without flax or msgpack.

agrl_tpu/core/checkpoint.py writes `flax.serialization.to_bytes(tree)`
plus a `<file>.json` sidecar of {"epoch", "rank1", "mAP"}. to_bytes
packs the state dict as msgpack with str keys and numpy arrays as ext
types (flax/serialization.py `_msgpack_ext_pack`):

  * ext 1 (ndarray)  — payload: msgpack array (shape, dtype name, bytes);
  * ext 3 (npscalar) — the same payload for a 0-d numpy scalar.

This module decodes that subset: maps with str keys, ints, floats, nil,
str, bin, arrays (inside the ext payloads) and ext types 1 and 3. It
raises ValueError on anything else, including flax's chunked-array
marker (arrays over 2**30 bytes, which no VMGN leaf reaches). Arrays come
back as read-only numpy views of the file's bytes.
"""

from __future__ import annotations

import json
import os.path as osp
import struct

import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"

# fixed-width scalars: tag -> struct format
_SCALARS = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
# length-prefixed: tag -> (kind, length format)
_SIZED = {
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_EXT = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"truncated msgpack: need {n} bytes at offset {self.pos}")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        at = self.pos
        tag = self.take(1)[0]
        if tag <= 0x7F:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self.map(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return [self.value() for _ in range(tag & 0x0F)]
        if 0xA0 <= tag <= 0xBF:
            return self.str(tag & 0x1F)
        if tag == 0xC0:
            return None
        if tag in _SCALARS:
            return self.unpack(_SCALARS[tag])
        if tag in _SIZED:
            kind, fmt = _SIZED[tag]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.str(n)
            if kind == "array":
                return [self.value() for _ in range(n)]
            return self.map(n)
        if tag in _FIXEXT:
            return self.ext(self.unpack(">b"), _FIXEXT[tag])
        if tag in _EXT:
            n = self.unpack(_EXT[tag])
            return self.ext(self.unpack(">b"), n)
        raise ValueError(f"msgpack type 0x{tag:02x} at offset {at} is not in the subset "
                         "flax.serialization.to_bytes writes for a checkpoint")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if not isinstance(key, str):
                raise ValueError(f"msgpack map key {key!r} is not a str")
            out[key] = self.value()
        if _CHUNKED in out:
            raise ValueError("chunked flax arrays (leaves over 2**30 bytes) are not supported")
        return out

    def ext(self, code: int, n: int):
        payload = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not a flax ndarray (1) or npscalar (3)")
        inner = _Reader(payload)
        shape, dtype_name, data = inner.value()
        if inner.pos != len(payload) or not isinstance(data, memoryview):
            raise ValueError("malformed flax ndarray payload")
        try:
            dtype = np.dtype(dtype_name)
        except TypeError as e:
            raise ValueError(f"unsupported array dtype {dtype_name!r}") from e
        arr = np.frombuffer(data, dtype=dtype).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def msgpack_restore(data: bytes):
    """Decode flax.serialization.to_bytes output into nested dicts of numpy
    arrays, as flax.serialization.msgpack_restore does."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(data):
        raise ValueError(f"{len(data) - reader.pos} trailing bytes after the msgpack value")
    return out


def read_checkpoint(fpath: str):
    """(tree, meta) of an agrl_tpu checkpoint: the msgpack tree and its
    `.json` sidecar ({"epoch": -1, "rank1": 0.0, "mAP": 0.0} without one,
    as agrl_tpu's load_checkpoint defaults)."""
    with open(fpath, "rb") as f:
        try:
            tree = msgpack_restore(f.read())
        except ValueError as e:
            raise ValueError(f"{fpath}: not an agrl_tpu msgpack checkpoint ({e})") from e
    meta = {"epoch": -1, "rank1": 0.0, "mAP": 0.0}
    if osp.exists(fpath + ".json"):
        with open(fpath + ".json") as f:
            meta.update(json.load(f))
    return tree, meta
