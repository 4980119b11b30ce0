"""Native TensorBoard scalar event writer — no tensorboardX dependency
(copy of agrl_tpu/utils/tbevents.py).

The reference logs scalars through tensorboardX's SummaryWriter
(train_vidreid_xent_htri.py:178,446-447); a migrating user expects TB to
open the run directory. The scalar path needs only two tiny protos
(Event + Summary.Value.simple_value) and TFRecord framing, hand-encoded
here (~60 LoC) so TB output is unconditional rather than gated on an
optional install.

Wire format (tensorflow/core/util/event.proto + record_writer.cc):
  record  := uint64le(len) crc32c(len bytes) data crc32c(data)
  crc     := masked castagnoli: ((c >> 15 | c << 32-15) + 0xa282ead8)
  Event   := 1:double wall_time | 2:varint step | 3:bytes file_version
             | 5:bytes Summary
  Summary := repeated 1: Value;  Value := 1:bytes tag | 2:float32 simple_value

The first record of every file is an Event{file_version: "brain.Event:2"}.
"""

from __future__ import annotations

import os
import socket
import struct
import time

# castagnoli polynomial (reflected) lookup table
_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = _crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _bytes_field(num: int, payload: bytes) -> bytes:
    return _field(num, 2) + _varint(len(payload)) + payload


def encode_scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    value_msg = (
        _bytes_field(1, tag.encode())
        + _field(2, 5)
        + struct.pack("<f", value)
    )
    summary = _bytes_field(1, value_msg)
    return (
        _field(1, 1)
        + struct.pack("<d", wall_time)
        + _field(2, 0)
        + _varint(step)
        + _bytes_field(5, summary)
    )


def encode_file_version_event(wall_time: float) -> bytes:
    return (
        _field(1, 1)
        + struct.pack("<d", wall_time)
        + _bytes_field(3, b"brain.Event:2")
    )


def frame_record(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + data
        + struct.pack("<I", _masked_crc(data))
    )


class EventFileWriter:
    """Append-only TB scalar event file in `log_dir`."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        host = socket.gethostname()
        fname = f"events.out.tfevents.{int(time.time())}.{host}"
        self._f = open(os.path.join(log_dir, fname), "ab")
        self._f.write(frame_record(encode_file_version_event(time.time())))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        ev = encode_scalar_event(tag, float(value), int(step), time.time())
        self._f.write(frame_record(ev))
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def read_records(path: str):
    """Parse a TFRecord event file back into raw proto bytes, verifying
    both CRCs — the test-side inverse of frame_record."""
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                return out
            (hcrc,) = struct.unpack("<I", f.read(4))
            assert hcrc == _masked_crc(header), "header crc mismatch"
            (length,) = struct.unpack("<Q", header)
            data = f.read(length)
            (dcrc,) = struct.unpack("<I", f.read(4))
            assert dcrc == _masked_crc(data), "data crc mismatch"
            out.append(data)


def decode_scalar_event(data: bytes):
    """Minimal proto decode of an Event record; returns
    (wall_time, step, [(tag, value), ...]) or file_version string."""
    pos, wall, step, scalars, version = 0, None, 0, [], None

    def _read_varint(buf, p):
        n = s = 0
        while True:
            b = buf[p]
            n |= (b & 0x7F) << s
            p += 1
            if not b & 0x80:
                return n, p
            s += 7

    def _parse_summary(buf):
        vals, p = [], 0
        while p < len(buf):
            key, p = _read_varint(buf, p)
            if key >> 3 == 1 and key & 7 == 2:
                ln, p = _read_varint(buf, p)
                v, tag, q = buf[p : p + ln], None, 0
                p += ln
                fval = None
                while q < len(v):
                    k2, q = _read_varint(v, q)
                    if k2 >> 3 == 1 and k2 & 7 == 2:
                        ln2, q = _read_varint(v, q)
                        tag = v[q : q + ln2].decode()
                        q += ln2
                    elif k2 >> 3 == 2 and k2 & 7 == 5:
                        (fval,) = struct.unpack("<f", v[q : q + 4])
                        q += 4
                    else:
                        raise ValueError(f"unexpected Value field {k2 >> 3}")
                vals.append((tag, fval))
            else:
                raise ValueError(f"unexpected Summary field {key >> 3}")
        return vals

    while pos < len(data):
        key, pos = _read_varint(data, pos)
        field, wire = key >> 3, key & 7
        if field == 1 and wire == 1:
            (wall,) = struct.unpack("<d", data[pos : pos + 8])
            pos += 8
        elif field == 2 and wire == 0:
            step, pos = _read_varint(data, pos)
        elif field == 3 and wire == 2:
            ln, pos = _read_varint(data, pos)
            version = data[pos : pos + ln].decode()
            pos += ln
        elif field == 5 and wire == 2:
            ln, pos = _read_varint(data, pos)
            scalars = _parse_summary(data[pos : pos + ln])
            pos += ln
        else:
            raise ValueError(f"unexpected Event field {field}/{wire}")
    return {"wall_time": wall, "step": step, "scalars": scalars, "version": version}
