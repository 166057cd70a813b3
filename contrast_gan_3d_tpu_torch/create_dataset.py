"""Contrast labels and cross-validation folds for a cohort of preprocessed
patients (the port's counterpart of the JAX package's
``scripts/create_dataset.py``):

    python -m contrast_gan_3d_tpu_torch.create_dataset patients/ out/ \\
        --n-folds 3 --seed 42

For every preprocessed patient under ``<patients>`` (``preprocess``'s
output: ``*.npy``, standalone ``*.h5`` patients and the members of ``*.h5``
corpus files; ``<patients>`` may itself be a corpus file) it samples
one 19^3 patch at 0.5 mm around each ostium on the card
(``ops/resample.sample_world_patch``), fits the Gaussian mixtures of
``data/labeling.py`` to all patches in one batched EM on the card, labels
each scan by its aortic-root HU (``label_ccta_scans``), and writes
``<out>/dataset.csv`` (``ID, path, mu, std, label``) and
``<out>/cross_val_splits.pkl`` (``{"train": [fold, ...], "test": [fold,
...]}``, the layout ``train --cval-splits`` reads). The sheet is csv: the
JAX script writes csv too where openpyxl is missing, as on the card's
machine. Runs on the card unless ``--device cpu``. HDF5 needs h5py, which
the card's machine lacks.
"""

import argparse
import logging
import pickle
import sys
import time
from pathlib import Path

import numpy as np
import torch

from contrast_gan_3d_tpu_torch.constants import AORTIC_ROOT_PATCH_SIZE, AORTIC_ROOT_PATCH_SPACING
from contrast_gan_3d_tpu_torch.data.labeling import (
    cross_val_splits,
    gmm_grid_search_batch,
    label_ccta_scans,
    pick_gmm_component,
    write_sheet,
)
from contrast_gan_3d_tpu_torch.data import hdf5
from contrast_gan_3d_tpu_torch.data.preprocess import load_patient
from contrast_gan_3d_tpu_torch.ops.resample import sample_world_patch
from contrast_gan_3d_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("contrast_gan_3d_tpu_torch.create_dataset")

SHEET_COLUMNS = ("ID", "path", "mu", "std", "label")


def patient_paths(src: Path) -> list:
    """The preprocessed patients under ``src``, as the JAX script lists
    them: the ``.npy`` files, sorted, then each ``.h5`` / ``.hdf5`` file's
    patients (a standalone patient, or a corpus file's members), or
    ``src``'s own when it is a corpus file. An HDF5 file of neither schema
    (a raw scan never preprocessed) fails, as does a directory without
    patients."""

    def members_or_raise(h5_file) -> list:
        members = hdf5.corpus_members(h5_file)
        if not members:
            raise SystemExit(f"{h5_file}: neither a preprocessed patient nor a corpus (no '{hdf5.SCAN_DS}' "
                             f"datasets); raw scans go through preprocess first")
        return members

    if src.suffix.lower() in (".h5", ".hdf5"):
        return members_or_raise(src)
    paths = [str(p) for p in sorted(src.glob("*.npy"))]
    for h5_file in sorted(src.glob("*.h5")) + sorted(src.glob("*.hdf5")):
        paths.extend(members_or_raise(h5_file))
    if not paths:
        raise SystemExit(f"{src}: no preprocessed patients (.npy/.h5) found")
    return paths


def ostia_patches(patient, device) -> tuple:
    """(name, (2, 19, 19, 19) f32 host array): the patient's ostia patches,
    sampled on ``device``."""
    data, meta = load_patient(patient)
    scan = torch.from_numpy(np.ascontiguousarray(data[..., 0])).to(device)
    centers = np.asarray(meta["ostia_world"], np.float64) - np.asarray(meta["offset"], np.float64)
    patches = sample_world_patch(scan, centers, meta["spacing"], tuple(AORTIC_ROOT_PATCH_SIZE),
                                 AORTIC_ROOT_PATCH_SPACING)
    return meta["name"], patches.cpu().numpy()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("patients_dir", type=Path, help="directory of preprocessed patients (.npy, .h5), or a .h5 corpus")
    p.add_argument("out_dir", type=Path)
    p.add_argument("--n-folds", type=int, default=3)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the command in-process; returns the sheet's rows, the folds, the
    paths written, each ostium's (mu, std) row and mixture size
    (``components``), and the seconds taken."""
    args = parse_args(argv)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(name)s | %(levelname)s | %(message)s")
    device = resolve_device(args.device)
    args.out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    patients = patient_paths(args.patients_dir)
    names, patches = [], []
    for patient in patients:
        name, p = ostia_patches(patient, device)
        names.append(name)
        patches.append(p)
    sample_s = time.perf_counter() - t0
    gmms = gmm_grid_search_batch(np.concatenate(patches), seed=args.seed, device=device)
    rows, it = [], iter(map(pick_gmm_component, gmms))
    for name, patient, p in zip(names, patients, patches):
        for _ in range(len(p)):
            mu, std = next(it)
            rows.append({"ID": name, "path": str(patient), "mu": mu, "std": std})
    labeled = label_ccta_scans(rows)
    sheet = write_sheet(labeled, args.out_dir / "dataset.csv", columns=SHEET_COLUMNS)
    counts = {}
    for row in labeled:
        counts[row["label"]] = counts.get(row["label"], 0) + 1
    logger.info("Wrote %s: %d scans, labels %s", sheet, len(labeled), counts)
    train, test = cross_val_splits(args.n_folds, sheet, seed=args.seed)
    splits = args.out_dir / "cross_val_splits.pkl"
    with open(splits, "wb") as fd:
        pickle.dump({"train": train, "test": test}, fd)
    seconds = time.perf_counter() - t0
    logger.info("Wrote %s (%.3f s per patient: sampling %.3f s, fits %.3f s)", splits, seconds / len(patients),
                sample_s / len(patients), (seconds - sample_s) / len(patients))
    return dict(sheet=sheet, splits=splits, rows=labeled, ostia=rows, components=[g.n_components for g in gmms],
                train=train, test=test,
                patients=len(patients), seconds=seconds, sample_seconds=sample_s)


if __name__ == "__main__":
    main()
    sys.exit(0)
