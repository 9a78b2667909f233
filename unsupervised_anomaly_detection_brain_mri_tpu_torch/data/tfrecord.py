"""TFRecord slice-cache interchange, without TensorFlow.

The reference persisted every preprocessed slice pool as a TFRecord of
`tf.train.Example` records (`utils/tfrecord_utils.py:14-52`): features
``height``/``width`` (int64) and ``image``/``label``/``set`` (raw
little-endian float32 / float32 / int32 bytes), one record per slice, in a
file named ``<DATASET-NAME>.tfrecord`` inside the dataset directory
(`dataloaders/BRAINWEB.py:380-381`).  A user migrating from the reference
already owns those files; this module reads and writes the exact format
with numpy only — the record framing (uint64 length + masked CRC32C of
the length + payload + masked CRC32C of the payload) and the protobuf
wire encoding of ``Example`` are implemented directly, so no TF or
protobuf dependency is needed.

Payload checksums are verified through the native C++ CRC32C
(`csrc_host/uadmri_native.cpp::uad_crc32c`, slice-by-8) when the library is
available; otherwise a pure-Python table CRC verifies the 8-byte length
prefixes only (cheap) and skips payload verification with ``verify=None``
(the default "auto") — pass ``verify=True`` to force full verification
through the Python fallback.

Copy of `unsupervised_anomaly_detection_brain_mri_tpu/data/tfrecord.py`
for the port: only the import paths differ.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from unsupervised_anomaly_detection_brain_mri_tpu_torch.data import native

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli, reflected polynomial 0x82F63B78) + TFRecord masking

_CRC_TABLE: List[int] = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def _crc32c_py(data: bytes, seed: int = 0) -> int:
    crc = seed ^ 0xFFFFFFFF
    tab = _CRC_TABLE
    for b in data:
        crc = tab[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc32c(data: bytes) -> int:
    got = native.crc32c(data)
    return _crc32c_py(data) if got is None else got


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf wire-format (only what tf.train.Example needs)

def _write_varint(out: bytearray, value: int) -> None:
    if value < 0:  # proto int64 semantics: two's-complement 64-bit
        value &= 0xFFFFFFFFFFFFFFFF
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long (corrupt record?)")


def _write_tag(out: bytearray, field: int, wire: int) -> None:
    _write_varint(out, (field << 3) | wire)


def _write_len_delimited(out: bytearray, field: int, payload: bytes) -> None:
    _write_tag(out, field, 2)
    _write_varint(out, len(payload))
    out += payload


def _skip_field(buf: memoryview, pos: int, wire: int) -> int:
    if wire == 0:
        _, pos = _read_varint(buf, pos)
    elif wire == 1:
        pos += 8
    elif wire == 2:
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wire == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire}")
    return pos


def _parse_feature(buf: memoryview):
    """Feature -> first value of its bytes_list/float_list/int64_list."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire != 2:
            pos = _skip_field(buf, pos, wire)
            continue
        n, pos = _read_varint(buf, pos)
        inner = buf[pos:pos + n]
        pos += n
        if field == 1:  # BytesList{ repeated bytes value = 1 }
            ipos = 0
            itag, ipos = _read_varint(inner, ipos)
            if itag >> 3 == 1 and itag & 7 == 2:
                ln, ipos = _read_varint(inner, ipos)
                return bytes(inner[ipos:ipos + ln])
        elif field == 2:  # FloatList{ repeated float value = 1 [packed] }
            ipos = 0
            itag, ipos = _read_varint(inner, ipos)
            if itag >> 3 == 1:
                if itag & 7 == 2:  # packed
                    ln, ipos = _read_varint(inner, ipos)
                    return struct.unpack("<f", inner[ipos:ipos + 4])[0]
                if itag & 7 == 5:
                    return struct.unpack("<f", inner[ipos:ipos + 4])[0]
        elif field == 3:  # Int64List{ repeated int64 value = 1 [packed] }
            ipos = 0
            itag, ipos = _read_varint(inner, ipos)
            if itag >> 3 == 1:
                if itag & 7 == 2:  # packed (TF's encoding)
                    _, ipos = _read_varint(inner, ipos)
                val, _ = _read_varint(inner, ipos)
                # proto int64: ten-byte two's-complement varint for
                # negatives (mirrors the _write_varint encode side)
                return val - (1 << 64) if val >= 1 << 63 else val
    return None


def _parse_example(payload: bytes) -> Dict[str, object]:
    """Example{ Features features = 1 } ->
    Features{ map<string, Feature> feature = 1 } as {key: first value}."""
    buf = memoryview(payload)
    feats: Dict[str, object] = {}
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        if tag >> 3 != 1 or tag & 7 != 2:
            pos = _skip_field(buf, pos, tag & 7)
            continue
        n, pos = _read_varint(buf, pos)
        features_msg = buf[pos:pos + n]
        pos += n
        fpos = 0
        while fpos < len(features_msg):
            ftag, fpos = _read_varint(features_msg, fpos)
            if ftag >> 3 != 1 or ftag & 7 != 2:
                fpos = _skip_field(features_msg, fpos, ftag & 7)
                continue
            fn, fpos = _read_varint(features_msg, fpos)
            entry = features_msg[fpos:fpos + fn]  # map entry: key=1, value=2
            fpos += fn
            key: Optional[str] = None
            value = None
            epos = 0
            while epos < len(entry):
                etag, epos = _read_varint(entry, epos)
                if etag & 7 != 2:
                    epos = _skip_field(entry, epos, etag & 7)
                    continue
                en, epos = _read_varint(entry, epos)
                blob = entry[epos:epos + en]
                epos += en
                if etag >> 3 == 1:
                    key = bytes(blob).decode("utf-8")
                elif etag >> 3 == 2:
                    value = _parse_feature(blob)
            if key is not None:
                feats[key] = value
    return feats


def _encode_int64_feature(value: int) -> bytes:
    packed = bytearray()
    _write_varint(packed, int(value))
    int64_list = bytearray()
    _write_len_delimited(int64_list, 1, bytes(packed))
    feature = bytearray()
    _write_len_delimited(feature, 3, bytes(int64_list))
    return bytes(feature)


def _encode_bytes_feature(value: bytes) -> bytes:
    bytes_list = bytearray()
    _write_len_delimited(bytes_list, 1, value)
    feature = bytearray()
    _write_len_delimited(feature, 1, bytes(bytes_list))
    return bytes(feature)


def _encode_example(features: Dict[str, bytes]) -> bytes:
    features_msg = bytearray()
    for key, feature in features.items():
        entry = bytearray()
        _write_len_delimited(entry, 1, key.encode("utf-8"))
        _write_len_delimited(entry, 2, feature)
        _write_len_delimited(features_msg, 1, bytes(entry))
    example = bytearray()
    _write_len_delimited(example, 1, bytes(features_msg))
    return bytes(example)


# ---------------------------------------------------------------------------
# Record-level API (mirrors `utils/tfrecord_utils.py:14-52`)

def iter_records(path: str, verify: Optional[bool] = None):
    """Yield raw record payloads from a TFRecord file.

    ``verify``: True = full CRC32C of every payload; False = none;
    None (auto) = full when the native CRC is available, else only the
    cheap 8-byte length-prefix CRCs.
    """
    if verify is None:
        verify = native.crc32c(b"") is not None
    import os as _os

    file_size = _os.path.getsize(path)
    with open(path, "rb") as f:
        while True:
            head = f.read(12)
            if not head:
                return
            if len(head) != 12:
                raise IOError(f"truncated TFRecord header: {path}")
            (length,), (len_crc,) = (struct.unpack("<Q", head[:8]),
                                     struct.unpack("<I", head[8:]))
            if _masked_crc(head[:8]) != len_crc:
                raise IOError(f"TFRecord length CRC mismatch: {path}")
            if length > file_size:  # a corrupt length must not drive a
                raise IOError(      # multi-GB read() allocation
                    f"truncated TFRecord payload (declared {length} bytes "
                    f"in a {file_size}-byte file): {path}")
            payload = f.read(length)
            tail = f.read(4)
            if len(payload) != length or len(tail) != 4:
                raise IOError(f"truncated TFRecord payload: {path}")
            if verify and _masked_crc(payload) != struct.unpack(
                    "<I", tail)[0]:
                raise IOError(f"TFRecord payload CRC mismatch: {path}")
            yield payload


def read_tf_record(path: str, verify: Optional[bool] = None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(images (N,H,W,C) f32, labels (N,H,W,C) f32, sets (N,) i32) from a
    reference-written TFRecord cache — `utils/tfrecord_utils.py:36-52`
    semantics, TF-free."""
    images, labels, sets = [], [], []
    for payload in iter_records(path, verify=verify):
        feats = _parse_example(payload)
        h, w = int(feats["height"]), int(feats["width"])
        images.append(
            np.frombuffer(feats["image"], np.float32).reshape(h, w, -1))
        labels.append(
            np.frombuffer(feats["label"], np.float32).reshape(h, w, -1))
        sets.append(int(np.frombuffer(feats["set"], np.int32)[0]))
    if not images:
        return (np.zeros((0, 1, 1, 1), np.float32),
                np.zeros((0, 1, 1, 1), np.float32),
                np.zeros((0,), np.int32))
    return (np.stack(images), np.stack(labels),
            np.asarray(sets, np.int32))


def write_tf_record(images: np.ndarray, labels: np.ndarray,
                    sets: np.ndarray, path: str) -> None:
    """Write a reference-compatible TFRecord cache
    (`utils/tfrecord_utils.py:14-33` schema: height/width int64,
    image/label/set raw LE bytes) that the reference's TF1 reader — and
    ``read_tf_record`` above — load unchanged."""
    images = np.ascontiguousarray(images, np.float32)
    labels = np.ascontiguousarray(labels, np.float32)
    sets = np.ascontiguousarray(sets, np.int32)
    # write-then-rename: a crashed export must not leave a truncated
    # .tfrecord in place, where the auto-import discovery would find it
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        for i in range(images.shape[0]):
            img = images[i]
            payload = _encode_example({
                "height": _encode_int64_feature(img.shape[0]),
                "width": _encode_int64_feature(img.shape[1]),
                "image": _encode_bytes_feature(img.tobytes()),
                "label": _encode_bytes_feature(labels[i].tobytes()),
                "set": _encode_bytes_feature(
                    sets[i].tobytes()),
            })
            head = struct.pack("<Q", len(payload))
            f.write(head)
            f.write(struct.pack("<I", _masked_crc(head)))
            f.write(payload)
            f.write(struct.pack("<I", _masked_crc(payload)))
    os.replace(tmp, path)
