"""TensorBoard event files without tensorflow or tensorboard (the GPU
machine has neither): the writer behind ``--tensorboard-dir``, and a
reader that checks every record.

A file is a sequence of TFRecords: the data's length (uint64), the masked
CRC32C of those 8 bytes (uint32), the data, and the masked CRC32C of the
data (uint32), all little-endian. Each record's data is an ``Event``
protobuf, encoded here by hand. The first event holds ``file_version
"brain.Event:2"``; each scalar is the event that TF2's
``tf.summary.scalar`` writes:

  Event{wall_time, step, summary{value{tag, tensor{dtype DT_FLOAT,
  tensor_shape{}, tensor_content <float32 LE>}, metadata{plugin_data{
  plugin_name "scalars"}}}}}

Files are named as TF2 names them:
``events.out.tfevents.<seconds>.<host>.<pid>.<n>.v2``.
"""

from __future__ import annotations

import itertools
import os
import socket
import struct
import time
from typing import Dict, Iterator, List, Tuple

__all__ = ["EventFileWriter", "read_events", "crc32c"]

_FILE_VERSION = "brain.Event:2"
_DT_FLOAT = 1
_file_numbers = itertools.count()  # TF2's per-process file counter


def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ----------------------------------------------------------- protobuf bits


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # int64 two's complement, as protobuf encodes it
    out = bytearray()
    while True:
        byte, n = n & 0x7F, n >> 7
        out.append(byte | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(number: int, payload: bytes) -> bytes:
    """A length-delimited field."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int, body: bytes) -> bytes:
    """Event{wall_time (1), step (2, omitted at 0), body}."""
    out = _varint(1 << 3 | 1) + struct.pack("<d", wall_time)
    if step:
        out += _varint(2 << 3 | 0) + _varint(step)
    return out + body


def _scalar_summary(tag: str, value: float) -> bytes:
    """Summary{value{tag (1), tensor (8), metadata (9)}}."""
    tensor = (_varint(1 << 3 | 0) + _varint(_DT_FLOAT) + _field(2, b"")
              + _field(4, struct.pack("<f", value)))
    metadata = _field(1, _field(1, b"scalars"))
    value_msg = _field(1, tag.encode("utf-8")) + _field(8, tensor) + _field(9, metadata)
    return _field(1, value_msg)


class EventFileWriter:
    """Appends scalar events to a new event file in ``logdir`` (made if
    missing)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        now = time.time()
        name = (f"events.out.tfevents.{int(now):010d}.{socket.gethostname()}."
                f"{os.getpid()}.{next(_file_numbers)}.v2")
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "wb")
        self._record(_event(now, 0, _field(3, _FILE_VERSION.encode())))
        self.flush()

    def _record(self, data: bytes) -> None:
        length = struct.pack("<Q", len(data))
        self._f.write(length + struct.pack("<I", _masked_crc(length)) + data
                      + struct.pack("<I", _masked_crc(data)))

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._record(_event(time.time(), int(step), _field(5, _scalar_summary(tag, value))))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


# ----------------------------------------------------------------- reading


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    n = shift = 0
    while True:
        b = data[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, pos


def _fields(data: bytes) -> Iterator[Tuple[int, object]]:
    """(field number, value) of a message: varints as ints, fixed64 and
    fixed32 as bytes, length-delimited fields as bytes."""
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(data, pos)
        elif wire == 1:
            value, pos = data[pos:pos + 8], pos + 8
        elif wire == 2:
            n, pos = _read_varint(data, pos)
            value, pos = data[pos:pos + n], pos + n
        elif wire == 5:
            value, pos = data[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"protobuf wire type {wire} is not read here")
        yield number, value


def _parse_value(data: bytes) -> Dict:
    out = {"tag": None, "value": None, "dtype": None, "plugin_name": None}
    for number, value in _fields(data):
        if number == 1:
            out["tag"] = value.decode("utf-8")
        elif number == 8:  # tensor
            for n, v in _fields(value):
                if n == 1:
                    out["dtype"] = v
                elif n == 4:
                    out["value"] = struct.unpack("<f", v)[0]
        elif number == 9:  # metadata.plugin_data.plugin_name
            for n, v in _fields(value):
                if n == 1:
                    for n2, v2 in _fields(v):
                        if n2 == 1:
                            out["plugin_name"] = v2.decode("utf-8")
    return out


def read_events(path: str) -> List[Dict]:
    """Every event of a file, each record's two CRCs checked: a list of
    ``{"wall_time", "step", "file_version" or None, "values": [{"tag",
    "value", "dtype", "plugin_name"}]}``."""
    with open(path, "rb") as f:
        data = f.read()
    events, pos = [], 0
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError(f"{path}: truncated record header at byte {pos}")
        length = data[pos:pos + 8]
        if struct.unpack("<I", data[pos + 8:pos + 12])[0] != _masked_crc(length):
            raise ValueError(f"{path}: bad length CRC at byte {pos}")
        n = struct.unpack("<Q", length)[0]
        body = data[pos + 12:pos + 12 + n]
        crc = data[pos + 12 + n:pos + 16 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError(f"{path}: truncated record at byte {pos}")
        if struct.unpack("<I", crc)[0] != _masked_crc(body):
            raise ValueError(f"{path}: bad data CRC at byte {pos}")
        pos += 16 + n
        event = {"wall_time": None, "step": 0, "file_version": None, "values": []}
        for number, value in _fields(body):
            if number == 1:
                event["wall_time"] = struct.unpack("<d", value)[0]
            elif number == 2:
                event["step"] = value - (1 << 64) if value >> 63 else value
            elif number == 3:
                event["file_version"] = value.decode("utf-8")
            elif number == 5:
                event["values"] += [_parse_value(v) for k, v in _fields(value) if k == 1]
        events.append(event)
    return events
