"""TensorBoard event-file writer — no tensorboard/tensorflow dependency.

A copy of ``ddp_tpu/train/events.py`` (standard library only).

The reference registers TensorboardLoggerHook / MMSegWandbHook
(depth/configs/ddp_nyu/...py:147-153; mmseg/core/hook/wandblogger_hook.py:14)
for scalar curves. This writes the same `events.out.tfevents.*` format those
tools read: TFRecord frames (length + masked-CRC32C) around hand-encoded
Event/Summary protobufs — scalars only, which is all the hooks log.

Wire format (tensorflow/core/util/event.proto, summary.proto):
  Event { 1: double wall_time; 2: int64 step; 5: Summary }
  Summary { 1: repeated Value { 1: string tag; 2: float simple_value } }
"""
from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict

_CRC_TABLE = []


def _make_table():
    poly = 0x82F63B78  # CRC-32C (Castagnoli), reflected
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_make_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = b""
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            out += bytes([b])
            return out


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _ld(field: int, payload: bytes) -> bytes:
    """length-delimited field"""
    return _tag(field, 2) + _varint(len(payload)) + payload


def _event(step: int, scalars: Dict[str, float], wall_time: float) -> bytes:
    values = b""
    for tag_name, v in scalars.items():
        val = (_ld(1, tag_name.encode())
               + _tag(2, 5) + struct.pack("<f", float(v)))
        values += _ld(1, val)
    ev = (_tag(1, 1) + struct.pack("<d", wall_time)
          + _tag(2, 0) + _varint(int(step))
          + _ld(5, values))
    return ev


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


class TBEventWriter:
    """Minimal SummaryWriter: scalars to events.out.tfevents.<ts>.<host>."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = os.path.join(logdir, name)
        # file-version header event (brain.Event:2), as TF writes it
        ver = (_tag(1, 1) + struct.pack("<d", time.time())
               + _ld(3, b"brain.Event:2"))
        with open(self.path, "wb") as f:
            f.write(_record(ver))

    def add_scalars(self, step: int, scalars: Dict[str, float]):
        ev = _event(step, scalars, time.time())
        with open(self.path, "ab") as f:
            f.write(_record(ev))

    def add_scalar(self, tag: str, value: float, step: int):
        self.add_scalars(step, {tag: value})
