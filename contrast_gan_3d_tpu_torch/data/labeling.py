"""Contrast labels and folds by label (counterpart of ``label_from_HU`` and
``divide_scans_in_fold`` in ``contrast_gan_3d_tpu/data/labeling.py``). The
GMM fit of the ostia patches (``compute_ostia_HU_stats``),
``cross_val_splits`` and the dataset sheets need sklearn and pandas, and
the HDF5 corpus expansion h5py, which the card's machine lacks: not ported
(ROADMAP.md, queue A item 6)."""

from typing import Dict, List


def label_from_HU(mu: float) -> int:
    """A scan's label from its aortic-root mean HU: 300 < mu < 500 -> 0
    (OPT), mu <= 300 -> -1 (LOW), mu >= 500 -> +1 (HIGH)."""
    if mu <= 300:
        return -1
    if mu >= 500:
        return 1
    return 0


def divide_scans_in_fold(fold) -> Dict[int, List]:
    """Group a fold's (path, label) pairs by label, in fold order."""
    out: Dict[int, List] = {}
    for path, label in fold:
        out.setdefault(int(label), []).append(path)
    return out
