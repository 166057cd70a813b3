"""Preprocessed patients on disk (counterpart of ``write_patient`` /
``load_patient`` in ``contrast_gan_3d_tpu/data/preprocess.py``): one
(W, H, D, 2) int16 ``<name>.npy`` (scan, centerline mask) and a
``<name>_meta.pkl`` metadata pickle (spacing, offset, centerlines, name).
The HDF5 format is not ported (no h5py on the card's machine; ROADMAP)."""

import pickle
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from contrast_gan_3d_tpu_torch.ops.block_conv import ROADMAP_NOTE



def _is_hdf5(path) -> bool:
    s = str(path)
    return "::" in s or s.lower().endswith((".h5", ".hdf5"))


def write_patient(volume: np.ndarray, centerlines_mask: np.ndarray, meta: Dict, name: str, out_dir,
                  fmt: str = "npy") -> Path:
    """Write ``<out_dir>/<name>.npy`` + ``<name>_meta.pkl``; returns the
    ``.npy`` path."""
    out_dir = Path(out_dir)
    if fmt != "npy" or _is_hdf5(out_dir):
        raise NotImplementedError(f"patient format {fmt!r} / HDF5 corpora are {ROADMAP_NOTE}")
    out_dir = out_dir.resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    scan_and_mask = np.stack([volume.astype(np.int16), centerlines_mask.astype(np.int16)], axis=-1)
    out_path = out_dir / f"{name}.npy"
    np.save(out_path, scan_and_mask)
    with open(out_dir / f"{name}_meta.pkl", "wb") as fd:
        pickle.dump(dict(meta) | {"name": name}, fd)
    return out_path


def load_patient(patient_path) -> Tuple[np.ndarray, Dict]:
    """mmap-load a preprocessed patient: ((W, H, D, 2) memmap, meta); the
    path may carry the ``.npy`` suffix or not."""
    if _is_hdf5(patient_path):
        raise NotImplementedError(f"HDF5 patients are {ROADMAP_NOTE}")
    path = str(patient_path)
    if path.endswith(".npy"):
        path = path[: -len(".npy")]
    data = np.load(path + ".npy", mmap_mode="r")
    with open(path + "_meta.pkl", "rb") as fd:
        meta = pickle.load(fd)
    return data, meta
