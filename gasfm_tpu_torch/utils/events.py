"""TensorBoard event files, written without the ``tensorboard`` package.

The JAX package logs its scalars through ``torch.utils.tensorboard``'s
``SummaryWriter`` (utils/observability.py ``get_tb_writer``), which needs
the ``tensorboard`` package. :class:`EventWriter` writes the same file by
hand: ``events.out.tfevents.<time>.<host>.<pid>.<n>`` in the log directory,
a sequence of TFRecords (the payload's length as a little-endian uint64, its
masked CRC-32C, the payload, the payload's masked CRC-32C), each payload an
``Event`` protobuf: first one with ``file_version = "brain.Event:2"``, then
one per scalar with ``wall_time``, ``step`` and ``summary.value {tag,
simple_value}`` (``SummaryWriter.add_scalar``'s default form; the value
stored as a float32). TensorBoard's own reader loads it.
"""

from __future__ import annotations

import itertools
import os
import socket
import struct
import time
from typing import Optional

import numpy as np


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as TFRecord framing uses it."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(payload: bytes) -> bytes:
    length = struct.pack("<Q", len(payload))
    return (length + struct.pack("<I", masked_crc32c(length)) + payload
            + struct.pack("<I", masked_crc32c(payload)))


# -- the protobuf wire format, for the few fields an Event needs -------------


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # int64 two's complement, as protobuf encodes negatives
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def event(wall_time: float, step: int = 0, file_version: Optional[str] = None,
          tag: Optional[str] = None, simple_value: Optional[float] = None) -> bytes:
    """An ``Event``: wall_time (1, double), step (2, int64), file_version
    (3, string), summary (5) holding one ``Summary.Value`` (1) of tag (1,
    string) and simple_value (2, float)."""
    out = _key(1, 1) + struct.pack("<d", wall_time)
    if step:
        out += _key(2, 0) + _varint(int(step))
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if tag is not None:
        with np.errstate(over="ignore"):  # beyond float32's range: inf, as torch's
            f32 = np.float32(simple_value).tobytes()
        value = _bytes_field(1, tag.encode()) + _key(2, 5) + f32
        out += _bytes_field(5, _bytes_field(1, value))
    return out


_uid = itertools.count()


class EventWriter:
    """``add_scalar`` / ``flush`` / ``close`` of a ``SummaryWriter`` that
    logs scalars only. The file is made at construction with its
    ``file_version`` event; records are buffered and written at
    :meth:`flush`."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "events.out.tfevents.%010d.%s.%s.%s" % (
            time.time(), socket.gethostname(), os.getpid(), next(_uid)))
        self._file = open(self.path, "wb")
        self._file.write(tfrecord(event(time.time(), file_version="brain.Event:2")))
        self._file.flush()

    def add_scalar(self, tag: str, scalar_value, global_step: Optional[int] = None,
                   walltime: Optional[float] = None) -> None:
        wall = time.time() if walltime is None else walltime
        self._file.write(tfrecord(event(wall, 0 if global_step is None else global_step,
                                        tag=tag, simple_value=float(scalar_value))))

    def flush(self) -> None:
        if not self._file.closed:
            self._file.flush()

    def close(self) -> None:
        if not self._file.closed:
            self._file.close()
