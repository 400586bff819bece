"""TensorBoard scalars without TensorBoard.

    writer = SummaryWriter(log_dir)          # events.out.tfevents.<time>.<host>
    writer.add_scalar("train/loss", 0.25, step)
    writer.close()
    read_scalars(path)  # -> [(step, tag, value, wall_time), ...], CRCs checked

The file is TensorBoard's event log: TFRecord framing (little-endian
uint64 length, masked CRC32C of the length, the payload, masked CRC32C of
the payload), a first record `Event{wall_time, file_version:
"brain.Event:2"}`, then one `Event{wall_time, step, summary{value{tag,
simple_value}}}` a scalar, the protobuf encoded here by hand. It is the
counterpart of the tensorboardX writer the JAX trainer uses, for hosts that
have neither tensorboardX nor tensorboard.
"""

from __future__ import annotations

import socket
import struct
import time
from pathlib import Path

_POLY = 0x82F63B78  # CRC-32C (Castagnoli), reflected
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _field(number: int, payload: bytes) -> bytes:
    """A length-delimited field (wire type 2)."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int | None = None, file_version: str | None = None,
           scalar: tuple[str, float] | None = None) -> bytes:
    out = b"\x09" + struct.pack("<d", wall_time)          # 1: wall_time, double
    if step is not None:
        out += b"\x10" + _varint(int(step))               # 2: step, int64
    if file_version is not None:
        out += _field(3, file_version.encode())           # 3: file_version
    if scalar is not None:
        tag, value = scalar
        val = _field(1, tag.encode()) + b"\x15" + struct.pack("<f", value)  # tag, simple_value
        out += _field(5, _field(1, val))                   # 5: summary { 1: value }
    return out


def _record(payload: bytes) -> bytes:
    length = struct.pack("<Q", len(payload))
    return (length + struct.pack("<I", masked_crc32c(length)) + payload
            + struct.pack("<I", masked_crc32c(payload)))


class SummaryWriter:
    """Scalars to `log_dir/events.out.tfevents.<time>.<host>`, each record
    flushed as it is written."""

    def __init__(self, log_dir):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        now = time.time()
        self.path = self.log_dir / f"events.out.tfevents.{int(now)}.{socket.gethostname()}"
        self._file = open(self.path, "ab")
        self._write(_event(now, file_version="brain.Event:2"))

    def _write(self, payload: bytes) -> None:
        self._file.write(_record(payload))
        self._file.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(time.time(), step=step, scalar=(tag, float(value))))

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        self._file.close()


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, pos


def _fields(buf: bytes):
    """(field number, wire type, value) of a protobuf message."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield number, wire, value


def read_scalars(path) -> list[tuple[int, str, float, float]]:
    """Every simple_value scalar of an event file, in file order, as (step,
    tag, value, wall_time); raises ValueError on a bad CRC or a cut record."""
    data = Path(path).read_bytes()
    pos, out = 0, []
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError(f"{path}: record header cut at byte {pos}")
        length = data[pos:pos + 8]
        (n,) = struct.unpack("<Q", length)
        if struct.unpack("<I", data[pos + 8:pos + 12])[0] != masked_crc32c(length):
            raise ValueError(f"{path}: bad length CRC at byte {pos}")
        payload = data[pos + 12:pos + 12 + n]
        crc = data[pos + 12 + n:pos + 16 + n]
        if len(payload) != n or len(crc) != 4:
            raise ValueError(f"{path}: record cut at byte {pos}")
        if struct.unpack("<I", crc)[0] != masked_crc32c(payload):
            raise ValueError(f"{path}: bad payload CRC at byte {pos}")
        pos += 16 + n
        wall, step, summary = 0.0, 0, None
        for number, _, value in _fields(payload):
            if number == 1:
                wall = struct.unpack("<d", value)[0]
            elif number == 2:
                step = value
            elif number == 5:
                summary = value
        if summary is None:
            continue
        for number, _, val in _fields(summary):
            if number != 1:
                continue
            tag, simple = None, None
            for vn, vw, vv in _fields(val):
                if vn == 1:
                    tag = vv.decode()
                elif vn == 2 and vw == 5:
                    simple = struct.unpack("<f", vv)[0]
            if tag is not None and simple is not None:
                out.append((step, tag, simple, wall))
    return out
