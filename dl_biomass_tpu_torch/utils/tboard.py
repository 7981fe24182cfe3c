"""Minimal TensorBoard event-file writer (no tensorboard dependency); copied
from ``dl_biomass_tpu/utils/tboard.py``.

The reference logs "Training MSE" / "Validation MSE" scalars per epoch via
torch's SummaryWriter (``Misc/main_V3.py:46,127-128``; 143 historical runs under
``runs/``). This is a from-scratch tfevents writer: hand-encoded Event protobufs
in the TFRecord framing (length + masked-crc32c), readable by standard
TensorBoard.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from datetime import datetime
from typing import Optional

import numpy as np

# ---- crc32c (Castagnoli), table-driven --------------------------------------

_POLY = 0x82F63B78
_TABLE = None


def _table():
    global _TABLE
    if _TABLE is None:
        t = np.zeros(256, np.uint32)
        for i in range(256):
            c = np.uint32(i)
            for _ in range(8):
                c = (c >> np.uint32(1)) ^ (np.uint32(_POLY) * (c & np.uint32(1)))
            t[i] = c
        _TABLE = t
    return _TABLE


def crc32c(data: bytes) -> int:
    t = _table()
    crc = np.uint32(0xFFFFFFFF)
    for b in data:
        crc = t[(crc ^ np.uint32(b)) & np.uint32(0xFF)] ^ (crc >> np.uint32(8))
    return int(crc ^ np.uint32(0xFFFFFFFF))


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ---- protobuf scalars ---------------------------------------------------------


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _bytes_field(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int = 0, file_version: Optional[str] = None,
           summary: Optional[bytes] = None) -> bytes:
    out = bytes([0x09]) + struct.pack("<d", wall_time)  # field 1 double
    if step:
        out += bytes([0x10]) + _varint(step)  # field 2 int64
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if summary is not None:
        out += _bytes_field(5, summary)
    return out


def _scalar_summary(tag: str, value: float) -> bytes:
    val = _bytes_field(1, tag.encode()) + bytes([0x15]) + struct.pack("<f", value)
    return _bytes_field(1, val)


class SummaryWriter:
    """Drop-in-enough SummaryWriter: ``scalar``/``add_scalar`` + ``flush``/``close``.

    Run directories are named like torch's: ``runs/<datetime>_<host><comment>``.
    """

    def __init__(self, logdir: Optional[str] = None, comment: str = ""):
        if logdir is None:
            stamp = datetime.now().strftime("%b%d_%H-%M-%S")
            logdir = os.path.join("runs", f"{stamp}_{socket.gethostname()}{comment}")
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self._f = open(os.path.join(logdir, fname), "wb")
        self._write_record(_event(time.time(), file_version="brain.Event:2"))

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._write_record(
            _event(time.time(), step=int(step), summary=_scalar_summary(tag, float(value)))
        )
        self._f.flush()

    # torch API alias
    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self.scalar(tag, value, step)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_scalars(event_file: str):
    """Parse scalars back out of a tfevents file -> list of (step, tag, value).
    Used by tests and by tooling that inspects the reference's ``runs/``."""
    out = []
    with open(event_file, "rb") as f:
        data = f.read()
    pos = 0
    while pos + 12 <= len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        payload = data[pos + 12 : pos + 12 + length]
        pos += 12 + length + 4
        # walk Event fields
        step, tag, value = 0, None, None
        i = 0
        while i < len(payload):
            key = payload[i]
            i += 1
            field, wire = key >> 3, key & 7
            if wire == 1:
                i += 8
            elif wire == 5:
                i += 4
            elif wire == 0:
                v = 0
                shift = 0
                while payload[i] & 0x80:
                    v |= (payload[i] & 0x7F) << shift
                    shift += 7
                    i += 1
                v |= payload[i] << shift
                i += 1
                if field == 2:
                    step = v
            elif wire == 2:
                ln = 0
                shift = 0
                while payload[i] & 0x80:
                    ln |= (payload[i] & 0x7F) << shift
                    shift += 7
                    i += 1
                ln |= payload[i] << shift
                i += 1
                sub = payload[i : i + ln]
                i += ln
                if field == 5:  # summary -> value -> tag/simple_value
                    j = 0
                    while j < len(sub):
                        k2 = sub[j]
                        j += 1
                        if k2 >> 3 == 1 and (k2 & 7) == 2:
                            ln2 = sub[j]
                            j += 1
                            val_msg = sub[j : j + ln2]
                            j += ln2
                            m = 0
                            while m < len(val_msg):
                                k3 = val_msg[m]
                                m += 1
                                if k3 >> 3 == 1 and (k3 & 7) == 2:
                                    ln3 = val_msg[m]
                                    m += 1
                                    tag = val_msg[m : m + ln3].decode()
                                    m += ln3
                                elif k3 >> 3 == 2 and (k3 & 7) == 5:
                                    (value,) = struct.unpack_from("<f", val_msg, m)
                                    m += 4
                                else:
                                    m = len(val_msg)
                        else:
                            j = len(sub)
        if tag is not None and value is not None:
            out.append((step, tag, value))
    return out
