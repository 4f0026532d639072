"""Dependency-free TensorBoard scalar event writer (mimm_tpu/tbevents.py
counterpart, the same bytes for the same scalars).

``metrics.MetricWriter(tensorboard=True)`` mirrors every numeric scalar of
its JSONL records through it.  The tfevents wire format is small and
stable: TFRecord framing (little-endian length + masked crc32c checksums)
around ``Event`` protobuf messages carrying ``Summary``/``simple_value``
scalars, so it is encoded here directly and needs neither the
``tensorboard`` package nor ``torch.utils.tensorboard``.

Wire layout (tensorflow/core/util/event.proto,
tensorflow/core/framework/summary.proto, TFRecord from
tensorflow/core/lib/io/record_writer.cc):

    Event:         double wall_time = 1; int64 step = 2;
                   string file_version = 3; Summary summary = 5;
    Summary:       repeated Value value = 1;
    Summary.Value: string tag = 1; float simple_value = 2;
    TFRecord:      uint64le len, uint32le masked_crc32c(len bytes),
                   data, uint32le masked_crc32c(data)
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

# ---------------------------------------------------------------------------
# crc32c (Castagnoli, reflected poly 0x82F63B78) — table-driven pure python
# ---------------------------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    """TFRecord's rotated+offset crc mask (record_writer.cc MaskedCrc)."""
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal protobuf encoding (only the wire types the Event message needs)
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    n &= 0xFFFFFFFFFFFFFFFF  # proto int64 two's complement
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_double(num: int, v: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", v)


def _field_float(num: int, v: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", v)


def _field_varint(num: int, v: int) -> bytes:
    return _varint(num << 3) + _varint(v)


def _field_bytes(num: int, v: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(v)) + v


def _scalar_event(wall_time: float, step: int, tag: str, value: float) -> bytes:
    summary_value = (_field_bytes(1, tag.encode("utf-8")) +
                     _field_float(2, float(value)))
    summary = _field_bytes(1, summary_value)
    return (_field_double(1, wall_time) + _field_varint(2, int(step)) +
            _field_bytes(5, summary))


def _version_event(wall_time: float) -> bytes:
    return _field_double(1, wall_time) + _field_bytes(3, b"brain.Event:2")


class TBEventWriter:
    """Append-only scalar writer producing a standard
    ``events.out.tfevents.<ts>.<host>`` file under ``logdir``."""

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        now = time.time()
        name = (f"events.out.tfevents.{int(now)}."
                f"{socket.gethostname()}{filename_suffix}")
        self.path = os.path.join(logdir, name)
        self._fh = open(self.path, "ab")
        self._record(_version_event(now))

    def _record(self, event: bytes) -> None:
        header = struct.pack("<Q", len(event))
        self._fh.write(header + struct.pack("<I", _masked_crc(header)) +
                       event + struct.pack("<I", _masked_crc(event)))

    def scalar(self, tag: str, value: float, step: int,
               wall_time: Optional[float] = None) -> None:
        if wall_time is None:  # NOT falsy-or: an explicit 0.0 is a valid stamp
            wall_time = time.time()
        self._record(_scalar_event(wall_time, step, tag, float(value)))

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.flush()
            self._fh.close()


# ---------------------------------------------------------------------------
# reading the records back (the tests and chip_smoke.py check a run's files)
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int):
    shift = value = 0
    while True:
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, pos


def _fields(buf: bytes):
    """(field number, wire type, value) of each field of one message."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield num, wire, value


def read_scalars(path: str) -> list:
    """Every scalar of the event file ``path`` as (wall_time, step, tag,
    value), in file order; raises ValueError on a record whose length or
    data checksum is wrong."""
    with open(path, "rb") as f:
        data = f.read()
    out, pos = [], 0
    while pos < len(data):
        header = data[pos:pos + 8]
        if len(header) < 8 or struct.unpack("<I", data[pos + 8:pos + 12])[0] \
                != _masked_crc(header):
            raise ValueError(f"{path}: bad record header at byte {pos}")
        (n,) = struct.unpack("<Q", header)
        event = data[pos + 12:pos + 12 + n]
        crc = data[pos + 12 + n:pos + 16 + n]
        if len(event) < n or len(crc) < 4 \
                or struct.unpack("<I", crc)[0] != _masked_crc(event):
            raise ValueError(f"{path}: bad record data at byte {pos}")
        pos += 16 + n
        wall_time, step, values = 0.0, 0, []
        for num, _, value in _fields(event):
            if num == 1:
                (wall_time,) = struct.unpack("<d", value)
            elif num == 2:
                step = value - (1 << 64) if value >= 1 << 63 else value
            elif num == 5:
                for _, _, summary_value in _fields(value):
                    tag, scalar = None, None
                    for vnum, _, v in _fields(summary_value):
                        if vnum == 1:
                            tag = v.decode("utf-8")
                        elif vnum == 2:
                            (scalar,) = struct.unpack("<f", v)
                    values.append((tag, scalar))
        out.extend((wall_time, step, tag, v) for tag, v in values)
    return out
