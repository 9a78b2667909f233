"""ctypes bindings for the native host data-path library.

Builds ``csrc_host/uadmri_native.cpp`` on first use (g++ -O3 -shared),
caches the shared object in ``<repo>/build/native/`` (never next to the
source), and exposes:

  * ``percentile_normalize`` — `utils/NII.py:53-75` parity, in C++,
  * ``resize_bilinear`` / ``resize_nearest`` — cv2-semantics slice resize,
  * ``write_cache`` / ``read_cache`` — binary slice cache; the payload is
    memory-mapped with numpy on read (zero-copy).

Everything degrades gracefully: if no compiler is available the callers
fall back to the numpy implementations (see ``available()``).

Copy of `unsupervised_anomaly_detection_brain_mri_tpu/data/native.py`
for the port: only the import paths and the library's build (into
``build/native/``, renamed into place once complete) differ.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc_host", "uadmri_native.cpp")
_SO = os.path.join(os.path.dirname(_PKG), "build", "native",
                   "libuadmri_native.so")

_HEADER_BYTES = 8 + 8 + 4 + 4


def _build() -> Optional[str]:
    if os.path.isfile(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(
            _SRC):
        return _SO
    # build beside the target and rename, so concurrent builders never load
    # a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        os.makedirs(os.path.dirname(_SO), exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True, capture_output=True)
        os.replace(tmp, _SO)
        return _SO
    except (OSError, subprocess.CalledProcessError):
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.uad_percentile_normalize.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
            ctypes.c_int]
        lib.uad_resize_bilinear.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int,
            ctypes.c_int]
        lib.uad_resize_nearest.argtypes = lib.uad_resize_bilinear.argtypes
        lib.uad_write_cache.argtypes = [
            ctypes.c_char_p, f32p, f32p, i32p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32]
        lib.uad_write_cache.restype = ctypes.c_int
        lib.uad_read_cache_header.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        lib.uad_read_cache_header.restype = ctypes.c_int
        if hasattr(lib, "uad_crc32c"):  # absent in pre-round-5 .so builds
            lib.uad_crc32c.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.c_uint32]
            lib.uad_crc32c.restype = ctypes.c_uint32
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def percentile_normalize(data: np.ndarray, lower_pct: Optional[float],
                         upper_pct: Optional[float],
                         method: str = "scaling") -> np.ndarray:
    """In-place percentile clamp + normalize; returns the array."""
    lib = _load()
    assert lib is not None
    data = np.ascontiguousarray(data, np.float32)
    lib.uad_percentile_normalize(
        _f32p(data), data.size,
        -1.0 if lower_pct is None else float(lower_pct),
        -1.0 if upper_pct is None else float(upper_pct),
        0 if method == "scaling" else 1)
    return data


def resize_bilinear(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    lib = _load()
    assert lib is not None
    src = np.ascontiguousarray(src, np.float32)
    dst = np.empty((dh, dw), np.float32)
    lib.uad_resize_bilinear(_f32p(src), src.shape[0], src.shape[1],
                            _f32p(dst), dh, dw)
    return dst


def resize_nearest(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    lib = _load()
    assert lib is not None
    src = np.ascontiguousarray(src, np.float32)
    dst = np.empty((dh, dw), np.float32)
    lib.uad_resize_nearest(_f32p(src), src.shape[0], src.shape[1],
                           _f32p(dst), dh, dw)
    return dst


def crc32c(data, seed: int = 0) -> Optional[int]:
    """CRC32C (Castagnoli) of a bytes-like object via the native lib;
    None when the lib (or the symbol, in a stale .so) is unavailable —
    callers fall back to `data/tfrecord.py`'s table implementation."""
    lib = _load()
    if lib is None or not hasattr(lib, "uad_crc32c"):
        return None
    buf = np.frombuffer(data, np.uint8)
    return int(lib.uad_crc32c(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size,
        ctypes.c_uint32(seed)))


def write_cache(path: str, images: np.ndarray, labels: np.ndarray,
                sets: np.ndarray) -> None:
    lib = _load()
    assert lib is not None
    images = np.ascontiguousarray(images, np.float32)
    labels = np.ascontiguousarray(labels, np.float32)
    sets = np.ascontiguousarray(sets, np.int32)
    n, h, w = images.shape[0], images.shape[1], images.shape[2]
    rc = lib.uad_write_cache(
        path.encode(), _f32p(images), _f32p(labels),
        sets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n, h, w)
    if rc != 0:
        raise IOError(f"native cache write failed ({rc}): {path}")


def read_cache(path: str, mmap: bool = True
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read (images, labels, sets); images/labels memory-mapped when
    ``mmap`` (zero-copy until first use)."""
    lib = _load()
    assert lib is not None
    n = ctypes.c_int64()
    h = ctypes.c_int32()
    w = ctypes.c_int32()
    rc = lib.uad_read_cache_header(path.encode(), ctypes.byref(n),
                                   ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"native cache read failed ({rc}): {path}")
    n, h, w = n.value, h.value, w.value
    hw = h * w
    mode = "r" if mmap else None
    img_off = _HEADER_BYTES
    lab_off = img_off + 4 * n * hw
    set_off = lab_off + 4 * n * hw
    if mmap:
        images = np.memmap(path, np.float32, "r", img_off, (n, h, w))
        labels = np.memmap(path, np.float32, "r", lab_off, (n, h, w))
        sets = np.memmap(path, np.int32, "r", set_off, (n,))
    else:
        with open(path, "rb") as f:
            raw = f.read()
        images = np.frombuffer(raw, np.float32, n * hw,
                               img_off).reshape(n, h, w)
        labels = np.frombuffer(raw, np.float32, n * hw,
                               lab_off).reshape(n, h, w)
        sets = np.frombuffer(raw, np.int32, n, set_off)
    return images, labels, sets
