"""TensorBoard event files written with the standard library alone.

The JAX package's trainer hands its scalars to ``tensorboardX.SummaryWriter``
where that package imports (``train.py``, ``core/trainer.py``). The machine
with the card has no tensorboardX and the port installs no package, so this
module writes the same file itself, and the port writes it always:

- a file ``events.out.tfevents.<10-digit time>.<hostname>`` in the logdir,
  tensorboardX's name;
- TFRecord framing: each record is its length (uint64, little endian), the
  masked CRC-32C of those 8 bytes, the data, the masked CRC-32C of the data;
- each record's data is an ``Event`` protobuf encoded here by hand: first
  one with ``file_version`` 'brain.Event:2', then one a scalar with
  ``wall_time``, ``step`` and a ``Summary`` of one ``Value`` (``tag``,
  ``simple_value``), the fields tensorboardX sets for ``add_scalar``.

:func:`read_events` parses such a file back (CRCs checked), for the tests
and ``chip_smoke.py``.
"""

from __future__ import annotations

import os
import re
import socket
import struct
import threading
import time

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1  # Castagnoli, reflected
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's mask of the CRC-32C of ``data``."""
    x = crc32c(data)
    return (((x >> 15) | (x << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # a negative int64 as protobuf encodes it: ten bytes
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field(number: int, wire: int, payload: bytes) -> bytes:
    return _varint(number << 3 | wire) + payload


def _bytes_field(number: int, data: bytes) -> bytes:
    return _field(number, 2, _varint(len(data)) + data)


def encode_event(wall_time: float, step: int = 0, file_version: str = "",
                 scalar: tuple[str, float] | None = None) -> bytes:
    """An ``Event`` message: wall_time (1, double), step (2, int64),
    file_version (3, string), summary (5: ``Summary.value`` (1) holding
    ``tag`` (1, string) and ``simple_value`` (2, float)); proto3 omits the
    fields outside a oneof at their default."""
    out = _field(1, 1, struct.pack("<d", wall_time))
    if step:
        out += _field(2, 0, _varint(int(step)))
    if file_version:
        out += _bytes_field(3, file_version.encode())
    if scalar is not None:
        tag, value = scalar
        # simple_value lies in a oneof: written even at 0
        val = (_bytes_field(1, tag.encode()) if tag else b"") + _field(2, 5, struct.pack("<f", value))
        out += _bytes_field(5, _bytes_field(1, val))
    return out


def record(data: bytes) -> bytes:
    """One TFRecord: length, its masked CRC, the data, its masked CRC."""
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", masked_crc32c(header)) + data
            + struct.pack("<I", masked_crc32c(data)))


_INVALID_TAG = re.compile(r"[^-/\w\.]")


def clean_tag(name: str) -> str:
    """tensorboardX's tag rule: characters other than [-/\\w.] become '_',
    a leading '/' goes."""
    return _INVALID_TAG.sub("_", name).lstrip("/")


class SummaryWriter:
    """``add_scalar`` into a new event file under ``logdir``, each record
    written and flushed at once (a run that is killed keeps what it wrote)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "events.out.tfevents." + str(time.time())[:10] + "."
                                 + socket.gethostname())
        self._lock = threading.Lock()
        self._file = open(self.path, "ab")
        self._write(encode_event(time.time(), file_version="brain.Event:2"))

    def _write(self, data: bytes) -> None:
        with self._lock:
            self._file.write(record(data))
            self._file.flush()

    def add_scalar(self, tag: str, value, global_step: int | None = None,
                   walltime: float | None = None) -> None:
        self._write(encode_event(time.time() if walltime is None else walltime,
                                 0 if global_step is None else int(global_step),
                                 scalar=(clean_tag(tag), float(value))))

    def close(self) -> None:
        with self._lock:
            self._file.close()


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    shift = value = 0
    while True:
        byte = buf[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return value, pos
        shift += 7


def _fields(buf: bytes):
    """(number, wire type, value) of each field of one message: an int for
    varints, bytes otherwise."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        elif wire == 2:
            size, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + size], pos + size
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield number, wire, value


def decode_event(data: bytes) -> dict:
    """The fields of an ``Event`` that :class:`SummaryWriter` writes:
    {'wall_time', 'step', 'file_version'?, 'scalars': [(tag, value), ...]}."""
    event = {"wall_time": 0.0, "step": 0, "scalars": []}
    for number, _, value in _fields(data):
        if number == 1:
            event["wall_time"] = struct.unpack("<d", value)[0]
        elif number == 2:
            event["step"] = value - (1 << 64) if value >= 1 << 63 else value
        elif number == 3:
            event["file_version"] = value.decode()
        elif number == 5:
            for vnum, _, val in _fields(value):
                if vnum != 1:
                    continue
                tag, simple = "", 0.0
                for fnum, _, f in _fields(val):
                    if fnum == 1:
                        tag = f.decode()
                    elif fnum == 2:
                        simple = struct.unpack("<f", f)[0]
                event["scalars"].append((tag, simple))
    return event


def read_records(path: str) -> list[bytes]:
    """The records' data of a TFRecord file; raises on a bad CRC or a cut."""
    with open(path, "rb") as f:
        blob = f.read()
    out, pos = [], 0
    while pos < len(blob):
        if pos + 12 > len(blob):
            raise ValueError(f"{path}: a record cut at byte {pos}")
        header = blob[pos:pos + 8]
        (length,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack("<I", blob[pos + 8:pos + 12])
        if crc != masked_crc32c(header):
            raise ValueError(f"{path}: the length CRC of the record at byte {pos} is wrong")
        data = blob[pos + 12:pos + 12 + length]
        end = pos + 12 + length
        if len(data) != length or end + 4 > len(blob):
            raise ValueError(f"{path}: a record cut at byte {pos}")
        (crc,) = struct.unpack("<I", blob[end:end + 4])
        if crc != masked_crc32c(data):
            raise ValueError(f"{path}: the data CRC of the record at byte {pos} is wrong")
        out.append(data)
        pos = end + 4
    return out


def read_events(path: str) -> list[dict]:
    """Every event of an event file, decoded (:func:`decode_event`)."""
    return [decode_event(data) for data in read_records(path)]
