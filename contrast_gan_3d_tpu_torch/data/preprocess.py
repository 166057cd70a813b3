"""Offline preprocessing: raw scans to patients (counterpart of
``contrast_gan_3d_tpu/data/preprocess.py``).

``create_patient`` loads a scan with its centerline point clouds and ostia
markers, optionally resamples it to ``out_spacing`` on the card
(``ops/resample.resample_volume``), rasterizes the centerlines into a mask
on the final grid from their world coordinates (no mask interpolation),
and writes one (W, H, D, 2) int16 ``<name>.npy`` (scan, centerline mask)
with a ``<name>_meta.pkl`` metadata pickle (spacing, offset, ostia,
centerlines, name). ``load_patient`` memory-maps it back, so training reads
only the cropped pages. ``fmt="h5"``, or an ``out_dir`` that is a ``.h5``
corpus file, writes HDF5 instead (``data/hdf5.py``; it needs h5py, which
the card's machine lacks): ``load_patient`` then returns the h5py dataset,
which crops the same way.
"""

import logging
import pickle
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from contrast_gan_3d_tpu_torch.data import hdf5
from contrast_gan_3d_tpu_torch.ops.resample import resample_volume
from contrast_gan_3d_tpu_torch.utils import geometry as geom
from contrast_gan_3d_tpu_torch.utils import io_utils

logger = logging.getLogger(__name__)


def create_patient(ccta_path, centerlines_dir, ostia_path, out_dir, out_spacing=None, fmt: str = "npy",
                   h5_chunks=None, device="cuda"):
    """Preprocess one patient into ``<out_dir>/<name>.npy`` +
    ``<name>_meta.pkl`` (or HDF5: ``write_patient``); returns the patient's
    path.

    ``out_spacing`` (a scalar or per-axis mm, optional) resamples the scan
    on ``device`` (the card unless the caller names the CPU; it is used
    only to resample) before the mask is rasterized; the default keeps the
    native spacing, as the reference does."""
    logger.info("Preprocessing '%s'...", ccta_path)
    volume, meta = io_utils.load_scan(ccta_path)  # (W, H, D) int16
    ostia_world, _ = io_utils.load_mevis_coords(ostia_path)  # (2, 3)
    centerlines_world = io_utils.load_centerlines(centerlines_dir)  # (N, 4)
    if out_spacing is not None:
        out_spacing = np.broadcast_to(np.asarray(out_spacing, np.float64), (3,)).copy()
        volume = resample_volume(volume, meta["spacing"], out_spacing, device=device)
        meta = dict(meta) | {"spacing": out_spacing}
    mask = geom.world_to_grid_coords(centerlines_world[..., :3], meta["offset"], meta["spacing"], volume.shape)
    name = io_utils.stem(ccta_path)
    meta = dict(meta) | {"ostia_world": ostia_world, "centerlines_world": centerlines_world}
    out_path = write_patient(volume, mask, meta, name, out_dir, fmt=fmt, h5_chunks=h5_chunks)
    logger.info("Created patient '%s'", out_path)
    return out_path


def write_patient(volume: np.ndarray, centerlines_mask: np.ndarray, meta: Dict, name: str, out_dir,
                  fmt: str = "npy", h5_chunks=None):
    """Write ``<out_dir>/<name>.npy`` + ``<name>_meta.pkl`` and return the
    ``.npy`` path; with ``fmt="h5"`` a standalone ``<out_dir>/<name>.h5``,
    and into an ``out_dir`` that is a ``.h5`` corpus file its member
    ``<out_dir>::<name>`` whatever ``fmt`` (``hdf5.write_patient_h5``;
    ``h5_chunks``: its chunk shape), returning that address."""
    out_dir = Path(out_dir)
    if fmt == "h5" or out_dir.suffix.lower() in (".h5", ".hdf5"):
        return hdf5.write_patient_h5(volume, centerlines_mask, meta, name, out_dir, chunks=h5_chunks)
    if fmt != "npy":
        raise ValueError(f"unknown patient format {fmt!r}: expected npy | h5")
    out_dir = out_dir.resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    scan_and_mask = np.stack([volume.astype(np.int16), centerlines_mask.astype(np.int16)], axis=-1)
    out_path = out_dir / f"{name}.npy"
    np.save(out_path, scan_and_mask)
    with open(out_dir / f"{name}_meta.pkl", "wb") as fd:
        pickle.dump(dict(meta) | {"name": name}, fd)
    return out_path


def load_patient(patient_path, h5_file_cache=None) -> Tuple[np.ndarray, Dict]:
    """mmap-load a preprocessed patient: ((W, H, D, 2) memmap, meta); the
    path may carry the ``.npy`` suffix or not. An HDF5 patient (``*.h5`` or
    ``corpus.h5::name``) returns its h5py dataset in place of the memmap;
    ``h5_file_cache`` shares one file handle among a corpus file's
    members (``hdf5.open_patient_h5``)."""
    if hdf5.is_hdf5_path(patient_path):
        return hdf5.open_patient_h5(patient_path, file_cache=h5_file_cache)
    path = str(patient_path)
    if path.endswith(".npy"):
        path = path[: -len(".npy")]
    data = np.load(path + ".npy", mmap_mode="r")
    with open(path + "_meta.pkl", "rb") as fd:
        meta = pickle.load(fd)
    return data, meta
