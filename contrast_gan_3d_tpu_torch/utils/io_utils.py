"""Medical-image I/O in numpy, gzip and zlib (the port's copy of the image
readers and writers in ``contrast_gan_3d_tpu/utils/io_utils.py``).

Reads .mhd/.mha and .nii/.nii.gz volumes, reorients them to LPS in index
order (W, H, D), casts to int16 and shifts/clips into [MIN_HU, MAX_HU];
writes compressed .mhd (with a .raw data file), .mha and .nii(.gz). Reads
and writes HDF5 scans (an ``image`` dataset in index order with
``spacing`` / ``offset`` / ``direction`` attributes, the JAX package's
schema) through h5py, imported only for an ``.h5`` path: the card's
machine has no h5py, and there such a path raises ``ImportError``. Parses the centerline point clouds (``vessel*.txt``), the
MeVisLab ostia markers (``ostia.xml``) and ASOCA annotation files.
"""

import gzip
import logging
import re
import zlib
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np

from contrast_gan_3d_tpu_torch.constants import MAX_HU, MIN_HU, ORIENTATION

logger = logging.getLogger(__name__)

PathLike = Union[str, Path]

# ---------------------------------------------------------------------------
# path helpers
# ---------------------------------------------------------------------------


def basename(path: PathLike) -> str:
    return Path(path).name


_IMAGE_SUFFIXES = (".nii.gz", ".nii", ".mhd", ".mha", ".npy", ".gz", ".h5", ".hdf5")


def stem(path: PathLike) -> str:
    """The file name without its imaging suffix. Only known suffixes are
    stripped, so DICOM-UID names such as '1.2.840.113.mhd' keep their dots;
    an HDF5 corpus member ``corpus.h5::name`` stems to its member name."""
    name = basename(path)
    if "::" in name:
        name = name.split("::")[-1]
    low = name.lower()
    for suffix in _IMAGE_SUFFIXES:
        if low.endswith(suffix):
            return name[: -len(suffix)]
    return name


def with_image_suffix(path: PathLike, suffix: str = ".mhd") -> Path:
    """Append ``suffix`` unless the name already ends with it (never
    ``Path.with_suffix``, which would replace the last dotted part of a
    DICOM-UID name)."""
    path = Path(path)
    if path.name.lower().endswith(suffix.lower()):
        return path
    return path.with_name(path.name + suffix)


# ---------------------------------------------------------------------------
# orientation: direction matrices live in ITK's LPS world frame,
# world = direction @ diag(spacing) @ index + origin
# ---------------------------------------------------------------------------

_LPS_LETTERS = (("R", "L"), ("A", "P"), ("I", "S"))  # (negative, positive) per world axis


def orientation_code(direction: np.ndarray) -> str:
    """3-letter anatomical code of each image axis in the LPS world frame."""
    code = []
    for col in range(3):
        axis = int(np.argmax(np.abs(direction[:, col])))
        positive = direction[axis, col] > 0
        code.append(_LPS_LETTERS[axis][int(positive)])
    return "".join(code)


def _code_to_axis_sign(code: str) -> Tuple[np.ndarray, np.ndarray]:
    axes, signs = [], []
    for letter in code:
        for world_axis, (neg, pos) in enumerate(_LPS_LETTERS):
            if letter == pos:
                axes.append(world_axis), signs.append(1)
            elif letter == neg:
                axes.append(world_axis), signs.append(-1)
    return np.array(axes), np.array(signs)


def reorient(
    volume_xyz: np.ndarray,
    direction: np.ndarray,
    spacing: np.ndarray,
    origin: np.ndarray,
    target: str = ORIENTATION,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Permute and flip ``volume_xyz`` so its axes align with ``target``;
    returns (volume, direction, spacing, origin) of the reoriented image
    (``sitk.DICOMOrient`` for axis-aligned direction matrices)."""
    direction = np.asarray(direction, dtype=np.float64).reshape(3, 3)
    spacing = np.asarray(spacing, dtype=np.float64).copy()
    origin = np.asarray(origin, dtype=np.float64).copy()

    src_axes, src_signs = _code_to_axis_sign(orientation_code(direction))
    tgt_axes, tgt_signs = _code_to_axis_sign(target)

    # for each target position, the source image axis along the same world axis
    perm = [int(np.nonzero(src_axes == wa)[0][0]) for wa in tgt_axes]
    volume = np.transpose(volume_xyz, perm)
    direction = direction[:, perm]
    spacing = spacing[perm]
    needs_flip = src_signs[perm] != tgt_signs

    for img_axis in range(3):
        if needs_flip[img_axis]:
            volume = np.flip(volume, axis=img_axis)
            # the new first voxel was the old last one along this axis
            origin = origin + direction[:, img_axis] * spacing[img_axis] * (volume.shape[img_axis] - 1)
            direction[:, img_axis] = -direction[:, img_axis]
    return np.ascontiguousarray(volume), direction, spacing, origin


# ---------------------------------------------------------------------------
# MetaImage (.mhd / .mha)
# ---------------------------------------------------------------------------

_MET_DTYPES = {
    "MET_CHAR": np.int8,
    "MET_UCHAR": np.uint8,
    "MET_SHORT": np.int16,
    "MET_USHORT": np.uint16,
    "MET_INT": np.int32,
    "MET_UINT": np.uint32,
    "MET_LONG": np.int64,
    "MET_ULONG": np.uint64,
    "MET_FLOAT": np.float32,
    "MET_DOUBLE": np.float64,
}
_DTYPE_MET = {np.dtype(v): k for k, v in _MET_DTYPES.items()}


def _read_mhd_header(fd, path) -> Dict[str, str]:
    """The MetaImage header lines up to ElementDataFile; leaves ``fd`` at
    the start of LOCAL data."""
    header: Dict[str, str] = {}
    while True:
        line = fd.readline()
        if not line:
            raise ValueError(f"{path}: no ElementDataFile key")
        text = line.decode("ascii", errors="replace").strip()
        if "=" not in text:
            continue
        key, value = (t.strip() for t in text.split("=", 1))
        header[key] = value
        if key == "ElementDataFile":
            return header


def _mhd_geometry(header: Dict[str, str], ndims: int) -> Dict:
    spacing = np.array([float(v) for v in header.get("ElementSpacing", "1 1 1").split()][:ndims])
    origin = np.array([float(v) for v in header.get("Offset", "0 0 0").split()][:ndims])
    direction = np.array(
        [float(v) for v in header.get("TransformMatrix", "1 0 0 0 1 0 0 0 1").split()]
    ).reshape(ndims, ndims)
    # MetaImage stores the matrix row-major with rows = image axes; ITK's
    # direction has columns = image axes
    return {"spacing": spacing, "offset": origin, "direction": direction.T}


def read_mhd(path: PathLike) -> Tuple[np.ndarray, Dict]:
    """A MetaImage volume in index order (x, y, z), and its geometry."""
    path = Path(path)
    with open(path, "rb") as fd:
        header = _read_mhd_header(fd, path)
        ndims = int(header.get("NDims", 3))
        dims = tuple(int(v) for v in header["DimSize"].split())
        dtype = np.dtype(_MET_DTYPES[header.get("ElementType", "MET_SHORT")])
        compressed = header.get("CompressedData", "False").lower() == "true"
        byte_order_msb = header.get(
            "BinaryDataByteOrderMSB", header.get("ElementByteOrderMSB", "False")
        ).lower() == "true"
        data_file = header["ElementDataFile"]
        raw = fd.read() if data_file == "LOCAL" else (path.parent / data_file).read_bytes()

    if compressed:
        raw = zlib.decompress(raw)
    array = np.frombuffer(raw, dtype=dtype, count=int(np.prod(dims)))
    if byte_order_msb:
        array = array.byteswap()
    # on disk the first index runs fastest
    array = np.transpose(array.reshape(dims[::-1]), tuple(range(ndims))[::-1])
    return array, _mhd_geometry(header, ndims)


def write_mhd(
    array_xyz: np.ndarray,
    path: PathLike,
    spacing: np.ndarray = None,
    origin: np.ndarray = None,
    direction: Optional[np.ndarray] = None,
    compress: bool = True,
):
    """Write a volume in index order (x, y, z) as .mhd + .raw (or one .mha),
    zlib-compressed by default; the header's floats round-trip exactly."""
    path = Path(path)
    if not path.name.lower().endswith((".mhd", ".mha")):
        path = with_image_suffix(path, ".mhd")
    ndims = array_xyz.ndim
    spacing = np.ones(ndims) if spacing is None else np.asarray(spacing)
    origin = np.zeros(ndims) if origin is None else np.asarray(origin)
    direction = np.eye(ndims) if direction is None else np.asarray(direction)

    raw = np.ascontiguousarray(np.transpose(array_xyz, tuple(range(ndims))[::-1])).tobytes()
    if compress:
        raw = zlib.compress(raw)

    local = path.suffix == ".mha"
    data_file = "LOCAL" if local else path.with_suffix(".raw").name
    lines = [
        "ObjectType = Image",
        f"NDims = {ndims}",
        "BinaryData = True",
        "BinaryDataByteOrderMSB = False",
        f"CompressedData = {compress}",
    ]
    if compress:
        lines.append(f"CompressedDataSize = {len(raw)}")

    def num(v):
        return repr(float(v))

    lines += [
        "TransformMatrix = " + " ".join(num(v) for v in direction.T.ravel()),
        "Offset = " + " ".join(num(v) for v in origin),
        "CenterOfRotation = " + " ".join("0" for _ in range(ndims)),
        "ElementSpacing = " + " ".join(num(v) for v in spacing),
        f"DimSize = {' '.join(str(d) for d in array_xyz.shape)}",
        f"ElementType = {_DTYPE_MET[np.dtype(array_xyz.dtype)]}",
        f"ElementDataFile = {data_file}",
    ]
    header = ("\n".join(lines) + "\n").encode("ascii")
    with open(path, "wb") as fd:
        fd.write(header)
        if local:
            fd.write(raw)
    if not local:
        (path.parent / data_file).write_bytes(raw)
    logger.debug("Wrote '%s'", path)


# ---------------------------------------------------------------------------
# NIfTI-1 (.nii / .nii.gz)
# ---------------------------------------------------------------------------

_NIFTI_DTYPES = {2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
                 256: np.int8, 512: np.uint16, 768: np.uint32}


def _parse_nifti_header(hdr: bytes, path) -> Dict:
    """The fixed 348-byte NIfTI-1 header: shape, dtype, data offset,
    scaling and the geometry in the LPS frame (no voxel data read)."""
    if hdr[344:348] not in (b"n+1\0", b"ni1\0"):
        raise ValueError(f"{path}: not a NIfTI-1 file")
    # the magic is endian-invariant, sizeof_hdr (348) is not
    bo = "<" if int(np.frombuffer(hdr, "<i4", 1, offset=0)[0]) == 348 else ">"
    if int(np.frombuffer(hdr, bo + "i4", 1, offset=0)[0]) != 348:
        raise ValueError(f"{path}: bad NIfTI-1 sizeof_hdr")
    dim = np.frombuffer(hdr, bo + "i2", 8, offset=40)
    datatype = int(np.frombuffer(hdr, bo + "i2", 1, offset=70)[0])
    pixdim = np.frombuffer(hdr, bo + "f4", 8, offset=76)
    vox_offset = int(np.frombuffer(hdr, bo + "f4", 1, offset=108)[0])
    scl_slope = float(np.frombuffer(hdr, bo + "f4", 1, offset=112)[0])
    scl_inter = float(np.frombuffer(hdr, bo + "f4", 1, offset=116)[0])
    qform_code = int(np.frombuffer(hdr, bo + "i2", 1, offset=252)[0])
    sform_code = int(np.frombuffer(hdr, bo + "i2", 1, offset=254)[0])

    ndim = int(dim[0])
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])[:3]
    dtype = np.dtype(_NIFTI_DTYPES[datatype])

    if sform_code > 0:
        srow = np.frombuffer(hdr, bo + "f4", 12, offset=280).reshape(3, 4)
        affine_ras = np.vstack([srow, [0, 0, 0, 1]])
    elif qform_code > 0:
        b, c, d = (float(np.frombuffer(hdr, bo + "f4", 1, offset=o)[0]) for o in (256, 260, 264))
        qo = np.array([float(np.frombuffer(hdr, bo + "f4", 1, offset=o)[0]) for o in (268, 272, 276)])
        a = np.sqrt(max(0.0, 1.0 - (b * b + c * c + d * d)))
        rot = np.array(
            [
                [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
                [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
                [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
            ]
        )
        qfac = -1.0 if pixdim[0] == -1 else 1.0
        affine_ras = np.eye(4)
        affine_ras[:3, :3] = rot @ np.diag([pixdim[1], pixdim[2], qfac * pixdim[3]])
        affine_ras[:3, 3] = qo
    else:
        affine_ras = np.diag([pixdim[1], pixdim[2], pixdim[3], 1.0])

    # RAS -> LPS: negate the first two world axes
    affine_lps = np.diag([-1.0, -1.0, 1.0, 1.0]) @ affine_ras
    mat = affine_lps[:3, :3]
    spacing = np.linalg.norm(mat, axis=0)
    direction = mat / spacing
    origin = affine_lps[:3, 3]
    return {
        "bo": bo,
        "shape": shape,
        "dtype": dtype,
        "vox_offset": vox_offset,
        "scl_slope": scl_slope,
        "scl_inter": scl_inter,
        "meta": {"spacing": spacing, "offset": origin, "direction": direction},
    }


def read_nifti(path: PathLike) -> Tuple[np.ndarray, Dict]:
    """A NIfTI-1 volume in index order (x, y, z), and its geometry in the
    LPS frame."""
    path = Path(path)
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as fd:
        blob = fd.read()
    h = _parse_nifti_header(blob[:348], path)
    n = int(np.prod(h["shape"]))
    array = np.frombuffer(blob, h["dtype"].newbyteorder(h["bo"]), n, offset=h["vox_offset"])
    array = np.transpose(array.reshape(h["shape"][::-1]), (2, 1, 0))  # x fastest on disk
    # scl_slope 0 (or non-finite) means no scaling at all, intercept included
    scl_slope, scl_inter = h["scl_slope"], h["scl_inter"]
    if np.isfinite(scl_slope) and scl_slope != 0.0 and (scl_slope != 1.0 or scl_inter != 0.0):
        array = array * scl_slope + scl_inter
    return array, h["meta"]


def write_nifti(volume_xyz: np.ndarray, path: PathLike, spacing=None, origin=None, direction=None):
    """Write a NIfTI-1 volume (.nii / .nii.gz), the inverse of
    :func:`read_nifti`: the geometry is given in the LPS frame and written
    as a RAS sform, with no scaling (scl_slope 0), every field
    little-endian."""
    volume_xyz = np.asarray(volume_xyz)
    if volume_xyz.ndim != 3:
        raise ValueError(f"write_nifti takes a 3D volume, got {volume_xyz.shape}")
    codes = {np.dtype(v): k for k, v in _NIFTI_DTYPES.items()}
    dtype = volume_xyz.dtype
    if dtype not in codes:
        raise ValueError(f"unsupported NIfTI dtype {dtype}")
    spacing = np.ones(3) if spacing is None else np.asarray(spacing, np.float64)
    origin = np.zeros(3) if origin is None else np.asarray(origin, np.float64)
    direction = np.eye(3) if direction is None else np.asarray(direction, np.float64)

    affine_lps = np.eye(4)
    affine_lps[:3, :3] = direction @ np.diag(spacing)
    affine_lps[:3, 3] = origin
    affine_ras = np.diag([-1.0, -1.0, 1.0, 1.0]) @ affine_lps

    hdr = bytearray(348)
    hdr[0:4] = np.int32(348).astype("<i4").tobytes()
    dim = np.zeros(8, "<i2")
    dim[0], dim[1:4] = 3, volume_xyz.shape
    dim[4:8] = 1
    hdr[40:56] = dim.tobytes()
    hdr[70:72] = np.int16(codes[dtype]).astype("<i2").tobytes()
    hdr[72:74] = np.int16(dtype.itemsize * 8).astype("<i2").tobytes()  # bitpix
    pixdim = np.zeros(8, "<f4")
    pixdim[0], pixdim[1:4] = 1.0, spacing
    hdr[76:108] = pixdim.tobytes()
    hdr[108:112] = np.float32(352.0).astype("<f4").tobytes()  # vox_offset
    hdr[112:116] = np.float32(0.0).astype("<f4").tobytes()  # scl_slope: no scaling
    hdr[254:256] = np.int16(1).astype("<i2").tobytes()  # sform = XFORM_SCANNER
    hdr[280:328] = affine_ras[:3, :].astype("<f4").tobytes()
    hdr[344:348] = b"n+1\0"

    # x fastest on disk; 4 bytes pad the header to vox_offset 352
    payload = bytes(hdr) + b"\0" * 4 + np.transpose(volume_xyz, (2, 1, 0)).astype(dtype.newbyteorder("<")).tobytes()
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(str(path), "wb") as fd:
        fd.write(payload)


# ---------------------------------------------------------------------------
# scans
# ---------------------------------------------------------------------------


def _is_hdf5(name: str) -> bool:
    return name.endswith((".h5", ".hdf5"))


def read_hdf5_image(path: PathLike) -> Tuple[np.ndarray, Dict]:
    """A raw volume stored in HDF5: dataset ``image`` in index order (x, y,
    z), attributes ``spacing`` / ``offset`` / ``direction`` (default 1 mm,
    0, identity, as :func:`read_mhd`'s)."""
    from contrast_gan_3d_tpu_torch.data.hdf5 import h5py_module

    with h5py_module().File(str(path), "r") as fd:
        if "image" not in fd:
            raise ValueError(f"{path}: no 'image' dataset (HDF5 scan schema)")
        array = np.asarray(fd["image"])
        ndims = array.ndim
        attrs = fd["image"].attrs
        spacing = np.asarray(attrs.get("spacing", np.ones(ndims)), np.float64)
        origin = np.asarray(attrs.get("offset", np.zeros(ndims)), np.float64)
        direction = np.asarray(attrs.get("direction", np.eye(ndims)), np.float64).reshape(ndims, ndims)
    return array, {"spacing": spacing, "offset": origin, "direction": direction}


def write_hdf5_image(volume_xyz: np.ndarray, path: PathLike, spacing=None, origin=None, direction=None,
                     compression: Optional[str] = None):
    """Write a raw volume in :func:`read_hdf5_image`'s schema."""
    from contrast_gan_3d_tpu_torch.data.hdf5 import h5py_module

    ndims = volume_xyz.ndim
    with h5py_module().File(str(path), "w") as fd:
        ds = fd.create_dataset("image", data=volume_xyz, compression=compression)
        ds.attrs["spacing"] = np.asarray(np.ones(ndims) if spacing is None else spacing, np.float64)
        ds.attrs["offset"] = np.asarray(np.zeros(ndims) if origin is None else origin, np.float64)
        ds.attrs["direction"] = np.asarray(np.eye(ndims) if direction is None else direction, np.float64)


def read_image(path: PathLike) -> Tuple[np.ndarray, Dict]:
    name = str(path).lower()
    if name.endswith((".mhd", ".mha")):
        return read_mhd(path)
    if name.endswith((".nii", ".nii.gz")):
        return read_nifti(path)
    if _is_hdf5(name):
        return read_hdf5_image(path)
    raise ValueError(f"Unsupported image format: {path}")


def read_image_meta(path: PathLike) -> Dict:
    """The on-disk geometry ``{spacing, offset, direction, shape}`` (before
    reorientation), from the header alone."""
    path = Path(path)
    name = str(path).lower()
    if name.endswith((".mhd", ".mha")):
        with open(path, "rb") as fd:
            header = _read_mhd_header(fd, path)
        meta = _mhd_geometry(header, int(header.get("NDims", 3)))
        meta["shape"] = tuple(int(v) for v in header["DimSize"].split())
        return meta
    if name.endswith((".nii", ".nii.gz")):
        opener = gzip.open if name.endswith(".gz") else open
        with opener(path, "rb") as fd:
            h = _parse_nifti_header(fd.read(348), path)
        return dict(h["meta"], shape=h["shape"])
    if _is_hdf5(name):
        from contrast_gan_3d_tpu_torch.data.hdf5 import h5py_module

        with h5py_module().File(path, "r") as fd:
            ds = fd["image"]
            ndims = ds.ndim
            return {"spacing": np.asarray(ds.attrs.get("spacing", np.ones(ndims))),
                    "offset": np.asarray(ds.attrs.get("offset", np.zeros(ndims))),
                    "direction": np.asarray(ds.attrs.get("direction", np.eye(ndims))),
                    "shape": tuple(int(s) for s in ds.shape)}
    raise ValueError(f"Unsupported image format: {path}")


def get_scan_orientation(path: PathLike) -> str:
    """Anatomical orientation code (e.g. ``'LPS'``) of the on-disk image,
    from its header."""
    return orientation_code(np.asarray(read_image_meta(path)["direction"]))


def load_scan(
    image_path: PathLike,
    segmentation: bool = False,
    target_orientation: str = ORIENTATION,
) -> Tuple[np.ndarray, Dict]:
    """A CCTA scan reoriented to LPS, as a (W, H, D) int16 volume shifted and
    clipped into [MIN_HU, MAX_HU], and its meta. Data stored with an
    unsigned offset (its minimum at least |MIN_HU| above MIN_HU) is shifted
    down first; the shift and clip run in int64, the cast to int16 last."""
    volume, meta = read_image(image_path)
    volume, direction, spacing, origin = reorient(
        volume, meta["direction"], meta["spacing"], meta["offset"], target_orientation
    )
    if segmentation:
        volume = volume.astype(np.int16)
    else:
        vol = volume.astype(np.int64)
        diff = int(vol.min()) - MIN_HU
        if diff >= abs(MIN_HU):
            vol = vol - diff
        volume = vol.clip(MIN_HU, MAX_HU).astype(np.int16)
    return volume, {
        "spacing": spacing,
        "offset": origin,
        "direction": direction,
        "orientation": orientation_code(direction),
        "min": int(volume.min()),
        "max": int(volume.max()),
    }


def save_scan(
    volume_whd: np.ndarray,
    offset: np.ndarray,
    spacing: np.ndarray,
    savepath: PathLike,
    direction: Optional[np.ndarray] = None,
):
    """Write a (W, H, D) volume as int16: compressed .mhd by default,
    NIfTI for a .nii / .nii.gz ``savepath``, HDF5 for a .h5 / .hdf5 one. ``direction`` is the LPS
    direction matrix to write (pass the loaded ``meta["direction"]`` to keep
    an oblique frame)."""
    volume_whd = volume_whd.astype(np.int16)
    name = str(savepath).lower()
    if name.endswith((".nii", ".nii.gz")):
        write_nifti(volume_whd, savepath, spacing=spacing, origin=offset, direction=direction)
    elif _is_hdf5(name):
        write_hdf5_image(volume_whd, savepath, spacing=spacing, origin=offset, direction=direction)
    else:
        write_mhd(volume_whd, savepath, spacing=spacing, origin=offset, direction=direction)


# ---------------------------------------------------------------------------
# centerline / annotation parsers
# ---------------------------------------------------------------------------


def load_centerlines(folder_path: PathLike, glob_str: Optional[str] = None) -> np.ndarray:
    """The ``vessel[0-9]*.txt`` point clouds of a folder, in sorted file
    order, concatenated: (N, 4) f32 rows of ``x y z r`` (world mm)."""
    files = sorted(Path(folder_path).glob(glob_str or "vessel[0-9]*.txt"))
    parts = [np.loadtxt(f, dtype=np.float32, ndmin=2) for f in files]
    if not parts:
        return np.empty((0, 4), dtype=np.float32)
    return np.concatenate(parts, axis=0, dtype=np.float32)


_TAG_RE = re.compile(r"<(ListSize|pos|vec)>(.*?)</\1>")


def load_mevis_coords(sourcefile: PathLike) -> Tuple[np.ndarray, np.ndarray]:
    """A MeVisLab XML marker file as (points (N, 3), vectors (N, 3)) f32:
    the first three values of each ``<pos>`` / ``<vec>``, cut to
    ``<ListSize>`` when it is given."""
    points, vecs = [], []
    n = 0
    with open(sourcefile) as fd:
        for line in fd:
            for m in _TAG_RE.finditer(line.strip()):
                tag, body = m.groups()
                if tag == "ListSize":
                    n = int(body)
                else:
                    (points if tag == "pos" else vecs).append([float(v) for v in body.split()][:3])
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    vcs = np.asarray(vecs, dtype=np.float32).reshape(-1, 3)
    if n:
        pts, vcs = pts[:n], vcs[:n]
    return pts, vcs


def load_ASOCA_annotated_centerlines(annotation_fname: PathLike) -> np.ndarray:
    """An ASOCA annotation file, one marker per line ``label x y z ...``:
    the values after the label as f64 rows (an empty array for none)."""
    rows = []
    with open(annotation_fname) as fd:
        for line in fd:
            parts = line.strip().split()
            if len(parts) > 1:
                rows.append([float(v) for v in parts[1:]])
    return np.asarray(rows, dtype=np.float64) if rows else np.empty((0,))
