"""Native medical-image format I/O: NIfTI-1, MINC(1/2), NRRD.

The reference delegated to SimpleITK / nibabel / pynrrd wheels
(`utils/NII.py:3`, `utils/MINC.py`, `dataloaders/NRRD.py`); none of those
are available here, so the formats are implemented directly:

  * NIfTI-1 (.nii / .nii.gz): 348-byte binary header + Fortran-ordered
    voxel data; read supports the common datatypes + scl_slope/scl_inter
    scaling; write emits float32 single-file (magic ``n+1``).
  * MINC1 (.mnc / .mnc.gz): NetCDF-classic container read via
    scipy.io.netcdf_file, with per-slice image-min/image-max renormalisation.
  * MINC2: HDF5 container read via h5py (``/minc-2.0/image/0/image``).
  * NRRD (.nrrd / .nhdr): text header + raw/gzip payload, read and write.

All loaders return ``(data, meta)`` with ``data`` float64 in (X, Y, Z)
axis order (axial slices along the last axis).

Copy of `unsupervised_anomaly_detection_brain_mri_tpu/data/formats.py`
for the port: only the import paths differ.
"""

from __future__ import annotations

import gzip
import io
import os
import struct
from typing import Any, Dict, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# NIfTI-1

_NIFTI_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}
_NIFTI_CODES = {np.dtype(v): k for k, v in _NIFTI_DTYPES.items()}


def _open_maybe_gz(path: str, mode: str = "rb"):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_nifti(path: str) -> Tuple[np.ndarray, Dict[str, Any]]:
    with _open_maybe_gz(path) as f:
        raw = f.read()
    hdr = raw[:348]
    sizeof_hdr = struct.unpack_from("<i", hdr, 0)[0]
    byte_order = "<"
    if sizeof_hdr != 348:
        byte_order = ">"
        sizeof_hdr = struct.unpack_from(">i", hdr, 0)[0]
        if sizeof_hdr != 348:
            raise ValueError(f"{path}: not a NIfTI-1 file")
    dim = struct.unpack_from(byte_order + "8h", hdr, 40)
    datatype = struct.unpack_from(byte_order + "h", hdr, 70)[0]
    pixdim = struct.unpack_from(byte_order + "8f", hdr, 76)
    vox_offset = int(struct.unpack_from(byte_order + "f", hdr, 108)[0])
    scl_slope = struct.unpack_from(byte_order + "f", hdr, 112)[0]
    scl_inter = struct.unpack_from(byte_order + "f", hdr, 116)[0]
    magic = hdr[344:348]
    if magic[:2] not in (b"n+", b"ni"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")
    if magic[:2] == b"ni":
        # detached .hdr/.img pair: voxels live in the sibling .img, and
        # vox_offset applies to THAT file (not the 352-byte single-file
        # minimum) — reading past the 348-byte header here would return
        # garbage or underflow the buffer
        base = str(path)
        gz = base.endswith(".gz")
        if gz:
            base = base[:-3]
        if not base.endswith(".hdr"):
            raise ValueError(
                f"{path}: detached-header magic 'ni1' in a non-.hdr file")
        for img_path in (base[:-4] + ".img", base[:-4] + ".img.gz"):
            if os.path.exists(img_path):
                with _open_maybe_gz(img_path) as f:
                    raw = f.read()
                break
        else:
            raise FileNotFoundError(
                f"{path}: detached NIfTI pair is missing its .img file")
        data_offset = max(vox_offset, 0)
    else:
        data_offset = max(vox_offset, 352)

    ndim = dim[0]
    shape = tuple(max(1, d) for d in dim[1: 1 + max(ndim, 3)])[:3]
    np_dtype = _NIFTI_DTYPES.get(datatype)
    if np_dtype is None:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    count = int(np.prod(shape))
    arr = np.frombuffer(
        raw, dtype=np.dtype(np_dtype).newbyteorder(byte_order),
        count=count, offset=data_offset)
    data = arr.reshape(shape, order="F").astype(np.float64)
    # NIfTI-1: scl_slope == 0 means NO scaling — scl_inter must be ignored
    # too (ANALYZE-derived headers leave garbage/NaN there); non-finite
    # values are likewise ignored rather than poisoning the volume
    if (np.isfinite(scl_slope) and np.isfinite(scl_inter)
            and scl_slope != 0.0
            and (scl_slope != 1.0 or scl_inter != 0.0)):
        data = data * scl_slope + scl_inter
    meta = {"pixdim": pixdim[1:4], "format": "nifti"}
    # voxel->world geometry: sform rows when sform_code > 0, else a
    # diagonal affine from pixdim (the reference keeps SimpleITK's
    # origin/direction for residual re-export, `utils/NII.py:18-21`)
    qform_code = struct.unpack_from(byte_order + "h", hdr, 252)[0]
    sform_code = struct.unpack_from(byte_order + "h", hdr, 254)[0]
    if sform_code > 0:
        srows = [struct.unpack_from(byte_order + "4f", hdr, off)
                 for off in (280, 296, 312)]
        meta["affine"] = [list(r) for r in srows]
    elif qform_code > 0:
        # qform-only headers (older converters/scanners): rebuild the
        # rotation from the unit quaternion + qfac so exports still
        # overlay on the source scan (NIfTI-1 standard method 2)
        b, c, d = struct.unpack_from(byte_order + "3f", hdr, 256)
        qx, qy, qz = struct.unpack_from(byte_order + "3f", hdr, 268)
        a = float(np.sqrt(max(0.0, 1.0 - (b * b + c * c + d * d))))
        R = np.array([
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d),
             2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d,
             2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b),
             a * a + d * d - b * b - c * c],
        ])
        qfac = -1.0 if pixdim[0] == -1.0 else 1.0
        scale = np.array([pixdim[1], pixdim[2], qfac * pixdim[3]])
        aff = np.concatenate(
            [R * scale[None, :], np.array([[qx], [qy], [qz]])], axis=1)
        meta["affine"] = aff.tolist()
    else:
        meta["affine"] = [[pixdim[1], 0.0, 0.0, 0.0],
                          [0.0, pixdim[2], 0.0, 0.0],
                          [0.0, 0.0, pixdim[3], 0.0]]
    return data, meta


def write_nifti(path: str, data: np.ndarray,
                pixdim: Tuple[float, float, float] = (1.0, 1.0, 1.0),
                affine=None) -> None:
    """Write a float32 single-file NIfTI-1.

    ``affine`` (3x4 or 4x4 voxel->world rows) takes precedence: it is
    written as the sform and pixdim is derived from its column norms, so
    volumes exported into a source scan's geometry overlay correctly in a
    viewer (parity with the reference keeping SimpleITK origin/direction,
    `utils/NII.py:18-21`, `utils/Evaluation.py:323-334`)."""
    data = np.asarray(data, np.float32)
    if data.ndim != 3:
        raise ValueError("write_nifti expects 3-D data")
    if affine is not None:
        aff = np.asarray(affine, np.float64)[:3, :4]
        pixdim = tuple(float(np.linalg.norm(aff[:, j])) for j in range(3))
        srows = aff
    else:
        srows = np.array([[pixdim[0], 0, 0, 0],
                          [0, pixdim[1], 0, 0],
                          [0, 0, pixdim[2], 0]], np.float64)
    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, *data.shape, 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, _NIFTI_CODES[np.dtype(np.float32)])
    struct.pack_into("<h", hdr, 72, 32)  # bitpix
    struct.pack_into("<8f", hdr, 76, 1.0, *pixdim, 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<h", hdr, 254, 1)  # sform_code
    struct.pack_into("<4f", hdr, 280, *srows[0])
    struct.pack_into("<4f", hdr, 296, *srows[1])
    struct.pack_into("<4f", hdr, 312, *srows[2])
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + data.tobytes(order="F")
    with _open_maybe_gz(path, "wb") as f:
        f.write(payload)


# ---------------------------------------------------------------------------
# MINC


def _read_minc1(path: str) -> Tuple[np.ndarray, Dict[str, Any]]:
    from scipy.io import netcdf_file

    if str(path).endswith(".gz"):
        with gzip.open(path, "rb") as f:
            buf = io.BytesIO(f.read())
        nc = netcdf_file(buf, mmap=False)
    else:
        nc = netcdf_file(path, mmap=False)
    try:
        var = nc.variables["image"]
        raw = np.asarray(var[:]).astype(np.float64)
        dims = [d.decode() if isinstance(d, bytes) else d
                for d in var.dimensions]
        valid_range = getattr(var, "valid_range", None)
        if valid_range is None:
            info = np.iinfo(var.data.dtype) if np.issubdtype(
                var.data.dtype, np.integer) else None
            valid_range = (info.min, info.max) if info else (raw.min(),
                                                             raw.max())
        vmin, vmax = float(valid_range[0]), float(valid_range[1])
        imin = imax = None
        if "image-min" in nc.variables:
            imin = np.asarray(nc.variables["image-min"][:], np.float64)
        if "image-max" in nc.variables:
            imax = np.asarray(nc.variables["image-max"][:], np.float64)
        if imin is not None and imax is not None and vmax > vmin:
            # per-slice renormalisation along the first (slowest) dimension
            shape = [raw.shape[0]] + [1] * (raw.ndim - 1)
            lo = np.broadcast_to(imin.reshape(
                shape if imin.size == raw.shape[0] else [1] * raw.ndim),
                raw.shape)
            hi = np.broadcast_to(imax.reshape(
                shape if imax.size == raw.shape[0] else [1] * raw.ndim),
                raw.shape)
            raw = lo + (raw - vmin) / (vmax - vmin) * (hi - lo)
        data = raw
    finally:
        nc.close()
    # MINC dimension order is typically (zspace, yspace, xspace) ->
    # transpose to (x, y, z)
    if len(dims) == 3:
        axes = {d: i for i, d in enumerate(dims)}
        order = [axes.get("xspace", 2), axes.get("yspace", 1),
                 axes.get("zspace", 0)]
        data = np.transpose(data, order)
    return data, {"format": "minc1", "dims": dims}


def _read_minc2(path: str) -> Tuple[np.ndarray, Dict[str, Any]]:
    import h5py

    opener = path
    if str(path).endswith(".gz"):
        with gzip.open(path, "rb") as f:
            opener = io.BytesIO(f.read())
    with h5py.File(opener, "r") as h5:
        node = h5["minc-2.0/image/0/image"]
        data = np.asarray(node[...], np.float64)
        # h5py returns string attrs as bytes OR str depending on how they
        # were stored — honor the recorded dimorder in both cases, only
        # falling back to the MINC default when the attribute is absent
        dimorder = node.attrs.get("dimorder", "zspace,yspace,xspace")
        if isinstance(dimorder, bytes):
            dimorder = dimorder.decode()
        dims = [str(d).strip() for d in str(dimorder).split(",")]
    if data.ndim == 3:
        axes = {d: i for i, d in enumerate(dims)}
        order = [axes.get("xspace", 2), axes.get("yspace", 1),
                 axes.get("zspace", 0)]
        data = np.transpose(data, order)
    return data, {"format": "minc2", "dims": dims}


def read_minc(path: str) -> Tuple[np.ndarray, Dict[str, Any]]:
    """Dispatch MINC1 (NetCDF, magic 'CDF') vs MINC2 (HDF5)."""
    with _open_maybe_gz(path) as f:
        magic = f.read(4)
    if magic[:3] == b"CDF":
        return _read_minc1(path)
    return _read_minc2(path)


def write_minc1(path: str, data: np.ndarray) -> None:
    """Write a minimal MINC1 (NetCDF classic) volume — primarily for tests
    and the downloader's conversion path."""
    from scipy.io import netcdf_file

    data = np.asarray(data, np.float64)
    buf = io.BytesIO()
    nc = netcdf_file(buf, "w")
    nc.createDimension("zspace", data.shape[2])
    nc.createDimension("yspace", data.shape[1])
    nc.createDimension("xspace", data.shape[0])
    var = nc.createVariable("image", np.float64,
                            ("zspace", "yspace", "xspace"))
    var[:] = np.transpose(data, (2, 1, 0))
    nc.flush()
    payload = buf.getvalue()
    nc.close()
    with _open_maybe_gz(path, "wb") as f:
        f.write(payload)


# ---------------------------------------------------------------------------
# NRRD

_NRRD_DTYPES = {
    "signed char": np.int8, "int8": np.int8, "uchar": np.uint8,
    "unsigned char": np.uint8, "uint8": np.uint8, "short": np.int16,
    "int16": np.int16, "ushort": np.uint16, "uint16": np.uint16,
    "int": np.int32, "int32": np.int32, "uint": np.uint32,
    "uint32": np.uint32, "float": np.float32, "double": np.float64,
    "int64": np.int64, "uint64": np.uint64,
}


def read_nrrd(path: str) -> Tuple[np.ndarray, Dict[str, Any]]:
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(b"NRRD"):
        raise ValueError(f"{path}: not a NRRD file")
    header_end = blob.find(b"\n\n")
    if header_end < 0:
        raise ValueError(f"{path}: missing NRRD header terminator")
    header_lines = blob[:header_end].decode("ascii",
                                            errors="replace").splitlines()
    fields: Dict[str, str] = {}
    for line in header_lines[1:]:
        if line.startswith("#") or ":" not in line:
            continue
        key, _, val = line.partition(":")
        fields[key.strip().lower()] = val.lstrip("=").strip()

    dtype = _NRRD_DTYPES[fields["type"]]
    sizes = tuple(int(s) for s in fields["sizes"].split())
    encoding = fields.get("encoding", "raw")
    endian = fields.get("endian", "little")
    datafile = fields.get("data file") or fields.get("datafile")

    if datafile:
        dpath = os.path.join(os.path.dirname(path), datafile)
        with open(dpath, "rb") as f:
            payload = f.read()
    else:
        payload = blob[header_end + 2:]
    if encoding in ("gzip", "gz"):
        payload = gzip.decompress(payload)
    elif encoding != "raw":
        raise ValueError(f"{path}: unsupported NRRD encoding {encoding}")
    np_dtype = np.dtype(dtype)
    if endian == "big":
        np_dtype = np_dtype.newbyteorder(">")
    arr = np.frombuffer(payload, dtype=np_dtype,
                        count=int(np.prod(sizes)))
    # NRRD lists sizes fastest-first: reshape in Fortran order
    data = arr.reshape(sizes, order="F").astype(np.float64)
    return data, {"format": "nrrd", "fields": fields}


def write_nrrd(path: str, data: np.ndarray, encoding: str = "raw") -> None:
    data = np.asarray(data, np.float32)
    header = (
        "NRRD0004\n"
        "type: float\n"
        f"dimension: {data.ndim}\n"
        f"sizes: {' '.join(str(s) for s in data.shape)}\n"
        f"encoding: {encoding}\n"
        "endian: little\n\n"
    )
    payload = data.tobytes(order="F")
    if encoding == "gzip":
        payload = gzip.compress(payload)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(payload)


def read_volume(path: str) -> Tuple[np.ndarray, Dict[str, Any]]:
    """Format dispatch by extension."""
    p = str(path)
    if p.endswith((".nii", ".nii.gz")):
        return read_nifti(p)
    if p.endswith((".mnc", ".mnc.gz")):
        return read_minc(p)
    if p.endswith((".nrrd", ".nhdr")):
        return read_nrrd(p)
    raise ValueError(f"unknown volume format: {p}")
