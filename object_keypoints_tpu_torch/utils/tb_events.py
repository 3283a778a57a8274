"""TensorBoard event-file writer — pure Python, no TensorFlow.

The port's copy of ``object_keypoints_tpu/utils/tb_events.py`` (the port
never imports the JAX package): the same bytes for the same scalars. The
reference logs its train/val scalars through Lightning's TensorBoard logger
into ``lightning_logs/version_x/events.out.tfevents.*``; this module
hand-encodes the two formats an event file is made of:

- **TFRecord framing**: ``uint64 length | uint32 masked-crc32c(length) |
  bytes data | uint32 masked-crc32c(data)``.
- **Event protobuf** (proto3 wire format, hand-encoded): ``Event{wall_time=1
  (double), step=2 (int64), file_version=3 (string), summary=5 (Summary)}``
  with ``Summary{value=1 (repeated Value{tag=1 (string), simple_value=2
  (float)})}``.

TensorBoard reads these files directly (`tensorboard --logdir <dir>`).
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Mapping

# ---------------------------------------------------------------------------
# crc32c (Castagnoli), table-driven.  Records are tens of bytes, so the pure
# Python loop is irrelevant next to the training step it logs.
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78  # reversed Castagnoli polynomial
        table = []
        for byte in range(256):
            crc = byte
            for _ in range(8):
                crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
            table.append(crc)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's rotated+offset crc mask."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf wire-format encoding (only what Event needs).
# ---------------------------------------------------------------------------


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _tag(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


def _double_field(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", value)


def _float_field(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _int64_field(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _bytes_field(field: int, value: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(value)) + value


def encode_scalar_event(step: int, scalars: Mapping[str, float],
                        wall_time: float) -> bytes:
    """Event{wall_time, step, summary={value: [{tag, simple_value}...]}}."""
    summary = b"".join(
        _bytes_field(
            1,  # Summary.value
            _bytes_field(1, tag.encode()) + _float_field(2, float(value)),
        )
        for tag, value in scalars.items()
    )
    return (
        _double_field(1, wall_time)
        + _int64_field(2, int(step))
        + _bytes_field(5, summary)
    )


def encode_file_version_event(wall_time: float) -> bytes:
    """The mandatory first record: Event{wall_time, file_version}."""
    return _double_field(1, wall_time) + _bytes_field(3, b"brain.Event:2")


def tfrecord(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (
        header
        + struct.pack("<I", masked_crc32c(header))
        + data
        + struct.pack("<I", masked_crc32c(data))
    )


class EventFileWriter:
    """Write scalar summaries TensorBoard can read.

    Creates ``events.out.tfevents.<time>.<host>`` in ``log_dir``, the file
    name pattern Lightning's logger produces (reference train.py:67-91 logs
    land under lightning_logs/version_x/).
    """

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = os.path.join(log_dir, name)
        self._file = open(self.path, "ab")
        self._file.write(tfrecord(encode_file_version_event(time.time())))
        self._file.flush()

    def add_scalars(self, step: int, scalars: Mapping[str, float],
                    wall_time: float | None = None):
        wall = time.time() if wall_time is None else wall_time
        self._file.write(tfrecord(encode_scalar_event(step, scalars, wall)))

    def flush(self):
        self._file.flush()

    def close(self):
        self._file.flush()
        self._file.close()
