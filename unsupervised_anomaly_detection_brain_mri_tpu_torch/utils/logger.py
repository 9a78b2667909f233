"""TensorBoard logging: per-phase event files, written without TensorBoard.

Counterpart of `unsupervised_anomaly_detection_brain_mri_tpu/utils/
logger.py`, with its API (``log_scalars``, ``log_visuals``, ``flush``,
``close``) and layout: one directory per phase, ``<logdir>/train``,
``<logdir>/val`` and ``<logdir>/test``, each holding an
``events.out.tfevents.*`` file.  The JAX module writes through
``tensorboardX``; the port writes the files itself, so it needs neither
``tensorboardX`` nor ``tensorboard``:

  * the file is TFRecord framing (uint64 length, masked CRC32C of the
    length, payload, masked CRC32C of the payload; ``data/tfrecord.py``);
  * each record is an ``Event`` protocol buffer, encoded by hand:
    ``wall_time`` (1, double), ``step`` (2, int64), and either
    ``file_version`` (3, the first record: ``brain.Event:2``) or
    ``summary`` (5) with one ``value`` (1) per tag: ``tag`` (1) and
    ``simple_value`` (2, float) or ``image`` (4: ``height`` 1, ``width`` 2,
    ``colorspace`` 3, ``encoded_image_string`` 4);
  * an image is an 8-bit RGB PNG made with ``zlib``, as ``tensorboardX``
    makes it from a one-channel float grid in [0, 1]: the channel
    repeated three times, times 255, truncated to uint8.
"""

from __future__ import annotations

import os
import socket
import struct
import time
import zlib
from typing import Dict, Optional

import numpy as np

from unsupervised_anomaly_detection_brain_mri_tpu_torch.data.tfrecord import (
    _masked_crc,
    _write_len_delimited,
    _write_tag,
    _write_varint,
)

PHASES = ("TRAIN", "VAL", "TEST")
FILE_VERSION = b"brain.Event:2"


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (8-bit RGB, no filter)."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rgb).reshape(h, w * 3)],
                          axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                              0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _png_chunk(b"IEND", b""))


def _event(step: int, *, summary: Optional[bytes] = None,
           file_version: Optional[bytes] = None) -> bytes:
    out = bytearray()
    _write_tag(out, 1, 1)  # wall_time, fixed64
    out += struct.pack("<d", time.time())
    _write_tag(out, 2, 0)
    _write_varint(out, int(step))
    if file_version is not None:
        _write_len_delimited(out, 3, file_version)
    if summary is not None:
        _write_len_delimited(out, 5, summary)
    return bytes(out)


def _scalar_value(tag: str, value: float) -> bytes:
    out = bytearray()
    _write_len_delimited(out, 1, tag.encode())
    _write_tag(out, 2, 5)  # simple_value, fixed32
    out += struct.pack("<f", value)
    return bytes(out)


def _image_value(tag: str, rgb: np.ndarray) -> bytes:
    image = bytearray()
    for field, v in ((1, rgb.shape[0]), (2, rgb.shape[1]), (3, 3)):
        _write_tag(image, field, 0)
        _write_varint(image, int(v))
    _write_len_delimited(image, 4, encode_png(rgb))
    out = bytearray()
    _write_len_delimited(out, 1, tag.encode())
    _write_len_delimited(out, 4, bytes(image))
    return bytes(out)


def _summary(values) -> bytes:
    out = bytearray()
    for v in values:
        _write_len_delimited(out, 1, v)
    return bytes(out)


class EventFile:
    """One ``events.out.tfevents.*`` file of TFRecord-framed ``Event``s,
    starting with the file-version event."""

    def __init__(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}.{os.getpid()}")
        self.path = os.path.join(directory, name)
        self._f = open(self.path, "wb")
        self.write(_event(0, file_version=FILE_VERSION))

    def write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header + struct.pack("<I", _masked_crc(header))
                      + payload + struct.pack("<I", _masked_crc(payload)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class Logger:
    """Lazy per-phase event files under ``logdir``."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self._writers: Dict[str, EventFile] = {}

    def _writer(self, phase: str) -> EventFile:
        if phase not in self._writers:
            self._writers[phase] = EventFile(
                os.path.join(self.logdir, phase.lower()))
        return self._writers[phase]

    def log_scalars(self, step: int, scalars: Dict[str, float],
                    phase: str = "TRAIN") -> None:
        values = [_scalar_value(tag, float(value))
                  for tag, value in scalars.items()
                  if np.isscalar(value) or np.ndim(value) == 0]
        w = self._writer(phase)
        for v in values:  # one event per tag, as tensorboardX writes
            w.write(_event(step, summary=_summary([v])))

    def log_visuals(self, step: int, x: np.ndarray, reconstruction: np.ndarray,
                    phase: str = "TRAIN", max_rows: int = 50) -> None:
        """The image ``reconstruction``: rows of input | reconstruction |
        L1 residual, each normalised to [0, 1], <= ``max_rows`` rows."""
        n = min(x.shape[0], max_rows)
        rows = []
        for i in range(n):
            xi = np.squeeze(x[i]).astype(np.float32)
            ri = np.squeeze(reconstruction[i]).astype(np.float32)
            di = np.abs(xi - ri)

            def norm(a):
                lo, hi = a.min(), a.max()
                return (a - lo) / (hi - lo) if hi > lo else a * 0

            rows.append(np.hstack([norm(xi), norm(ri), norm(di)]))
        grid = np.vstack(rows)
        rgb = np.repeat((grid * 255.0).astype(np.uint8)[:, :, None], 3, 2)
        self._writer(phase).write(_event(step, summary=_summary(
            [_image_value("reconstruction", rgb)])))

    def flush(self) -> None:
        for w in self._writers.values():
            w.flush()

    def close(self) -> None:
        for w in self._writers.values():
            w.close()
