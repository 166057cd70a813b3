"""Folds by label (counterpart of ``divide_scans_in_fold`` in
``contrast_gan_3d_tpu/data/labeling.py``). The GMM labelling and
``cross_val_splits`` need sklearn and pandas, and the HDF5 corpus
expansion h5py: not ported (ROADMAP)."""

from typing import Dict, List


def divide_scans_in_fold(fold) -> Dict[int, List]:
    """Group a fold's (path, label) pairs by label, in fold order."""
    out: Dict[int, List] = {}
    for path, label in fold:
        out.setdefault(int(label), []).append(path)
    return out
