"""Minimal pure-numpy NIfTI-1 reader/writer (.nii / .nii.gz), a copy of
``multimodal_pl_tpu/data/nifti.py``.

The reference reads volumes with SimpleITK (MOTSDataset.py:303-304) and writes
with SimpleITK/nibabel; neither is available here, and the hot path only needs
raw arrays + spacing, so this implements the NIfTI-1 format directly: a
348-byte header (+4-byte extension flag) followed by the voxel data, with
optional gzip. Data is returned in (Z, Y, X) index order — the same array
orientation ``sitk.GetArrayFromImage`` produces for RAS-oriented volumes —
and scl_slope/scl_inter scaling is applied like nibabel's get_fdata().
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64, 1280: np.uint64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass
class NiftiImage:
    data: np.ndarray                      # (Z, Y, X) array order
    spacing: Tuple[float, float, float]   # (sx, sy, sz) voxel size, xyz order
    affine: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))


def _open(path: str, mode: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_nifti(path: str) -> NiftiImage:
    with _open(path, "rb") as f:
        raw = f.read()
    hdr = raw[:348]
    sizeof_hdr = struct.unpack_from("<i", hdr, 0)[0]
    if sizeof_hdr != 348:
        raise ValueError(f"{path}: not a little-endian NIfTI-1 file (sizeof_hdr={sizeof_hdr})")
    dim = struct.unpack_from("<8h", hdr, 40)
    ndim = dim[0]
    shape_xyz = dim[1 : 1 + max(ndim, 3)]
    datatype = struct.unpack_from("<h", hdr, 70)[0]
    pixdim = struct.unpack_from("<8f", hdr, 76)
    vox_offset = int(struct.unpack_from("<f", hdr, 108)[0])
    scl_slope = struct.unpack_from("<f", hdr, 112)[0]
    scl_inter = struct.unpack_from("<f", hdr, 116)[0]
    srow = np.array(
        [struct.unpack_from("<4f", hdr, 280), struct.unpack_from("<4f", hdr, 296),
         struct.unpack_from("<4f", hdr, 312), [0, 0, 0, 1]],
        np.float32,
    )
    dtype = _DTYPES.get(datatype)
    if dtype is None:
        raise ValueError(f"{path}: unsupported NIfTI datatype code {datatype}")
    count = int(np.prod(shape_xyz[:3]))
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=vox_offset or 352)
    # NIfTI stores x-fastest; reshape to (Z, Y, X) like sitk.GetArrayFromImage
    data = data.reshape(tuple(reversed(shape_xyz[:3])))
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter
    return NiftiImage(
        data=np.ascontiguousarray(data),
        spacing=(float(pixdim[1]), float(pixdim[2]), float(pixdim[3])),
        affine=srow,
    )


def write_nifti(path: str, data: np.ndarray, spacing=(1.0, 1.0, 1.0)) -> None:
    """Write a (Z, Y, X) array as NIfTI-1 with the given xyz spacing."""
    data = np.ascontiguousarray(data)
    code = _CODES.get(data.dtype)
    if code is None:
        data = data.astype(np.float32)
        code = 16
    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    shape_xyz = tuple(reversed(data.shape))
    struct.pack_into("<8h", hdr, 40, 3, *shape_xyz, *( [1] * (7 - len(shape_xyz)) ))
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)  # bitpix
    struct.pack_into("<8f", hdr, 76, 1.0, spacing[0], spacing[1], spacing[2], 0, 0, 0, 0)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)    # scl_slope
    struct.pack_into("<h", hdr, 252, 1)      # qform_code... keep minimal: sform below
    struct.pack_into("<h", hdr, 254, 1)      # sform_code = SCANNER_ANAT
    struct.pack_into("<4f", hdr, 280, spacing[0], 0, 0, 0)
    struct.pack_into("<4f", hdr, 296, 0, spacing[1], 0, 0)
    struct.pack_into("<4f", hdr, 312, 0, 0, spacing[2], 0)
    hdr[344:348] = b"n+1\x00"
    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(data.tobytes())
