"""Dependency-free TensorBoard scalar logging.

The port's own copy of `speechless_tpu/utils/tensorboard.py`. The original speechless
attaches a Keras TensorBoard callback (its `net.py:574-576`).
This writer produces standard TensorBoard event files (TFRecord framing + Event/Summary
protobuf wire format, hand-encoded — no tensorflow/tensorboard dependency), so training
curves stay viewable with stock TensorBoard alongside the CSV scalars.
"""
import socket
import struct
import time
from pathlib import Path
from typing import Optional

_CRC_TABLE = None


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), table-driven."""
    global _CRC_TABLE
    if _CRC_TABLE is None:
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
            table.append(crc)
        _CRC_TABLE = table
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field_bytes(number: int, payload: bytes) -> bytes:
    return _varint((number << 3) | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int, *, file_version: Optional[str] = None,
           tag: Optional[str] = None, value: Optional[float] = None) -> bytes:
    event = bytearray()
    event += b"\x09" + struct.pack("<d", wall_time)          # double wall_time = 1
    event += b"\x10" + _varint(step)                          # int64 step = 2
    if file_version is not None:
        event += _field_bytes(3, file_version.encode())       # string file_version = 3
    if tag is not None:
        summary_value = (_field_bytes(1, tag.encode()) +      # Value.tag = 1
                         b"\x15" + struct.pack("<f", value))  # Value.simple_value = 2
        summary = _field_bytes(1, summary_value)              # Summary.value = 1
        event += _field_bytes(5, summary)                     # Event.summary = 5
    return bytes(event)


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header)) + payload +
            struct.pack("<I", _masked_crc(payload)))


class SummaryWriter:
    """Minimal TensorBoard scalar writer: ``add_scalar(tag, value, step)``."""

    def __init__(self, log_dir: Path):
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        name = "events.out.tfevents.{:.6f}.{}.v2".format(time.time(), socket.gethostname())
        self._file = (log_dir / name).open("wb")
        self._file.write(_record(_event(time.time(), 0, file_version="brain.Event:2")))
        self._file.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._file.write(_record(_event(time.time(), step, tag=tag, value=float(value))))

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        if not self._file.closed:
            self._file.flush()
            self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()
