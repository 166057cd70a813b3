"""The HU-distribution-shift evaluation in numpy (counterpart of
``contrast_gan_3d_tpu/eval/hu_distribution_shift.py``).

For each evaluation scan, gather the voxel intensities under the coronary
centerlines, the ostia and (optionally) a myocardium segmentation, then
aggregate them per ScanType. Comparing original and corrected scans with
genuinely optimal ones says how far the correction moves contrast toward
the optimal 350-450 HU corridor. Host-side numpy; patients fan out over a
thread pool (the loads release the GIL)."""

import logging
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from contrast_gan_3d_tpu_torch.constants import ScanType
from contrast_gan_3d_tpu_torch.utils import geometry as geom
from contrast_gan_3d_tpu_torch.utils import io_utils

logger = logging.getLogger(__name__)


def _point_mask_voxels(ccta, points_world, offset, spacing) -> np.ndarray:
    """The HU values a ``world_to_grid_coords`` mask of the points would
    gather, in the same order (C order of the mask = the sorted unique
    voxels), without building the full-resolution grid."""
    img = np.unique(geom.world_to_image_coords(points_world, offset, spacing), axis=0)
    clipped = np.stack([np.clip(img[:, i], 0, ccta.shape[i] - 1) for i in range(3)], axis=-1)
    return ccta[tuple(np.unique(clipped, axis=0).T)]


def collect_patient_voxels(scan_path, centerline_path, myocardium_path: Optional[str] = None) -> Dict[str, np.ndarray]:
    """HU values under the centerline, ostia and myocardium masks of one
    scan; the ostia come from ``<centerline_path>/ostia.xml``."""
    ccta, meta = io_utils.load_scan(scan_path)
    offset, spacing = meta["offset"], meta["spacing"]
    centerlines_world = io_utils.load_centerlines(centerline_path)[..., :3]
    ostia_world, _ = io_utils.load_mevis_coords(Path(centerline_path) / "ostia.xml")
    out = {
        "centerlines": _point_mask_voxels(ccta, centerlines_world, offset, spacing),
        "ostia": _point_mask_voxels(ccta, ostia_world, offset, spacing),
    }
    if myocardium_path is not None:
        myo, _ = io_utils.load_scan(myocardium_path, segmentation=True)
        out["myocardium"] = ccta[myo.astype(bool)]
    return out


def collect_voxels_intensity(evaluation_paths: Sequence[Tuple[Sequence, int]],
                             workers: int = 8) -> Dict[ScanType, Dict[str, np.ndarray]]:
    """Masked voxels of every ((scan, centerline dir[, myocardium]), label)
    pair, concatenated per ScanType and region in list order. A patient
    that fails to load is logged and skipped."""
    labels = [label for _, label in evaluation_paths]
    logger.info("Scans by label: %s", {ScanType(k).name: labels.count(k) for k in set(labels)})

    def one(entry):
        paths, label = entry
        try:
            return label, collect_patient_voxels(*paths)
        except Exception as e:  # one unreadable patient must not abort the sweep
            logger.error("FAILED %r: %s", str(paths[0]), e)
            return None

    with ThreadPoolExecutor(max_workers=workers) as pool:
        results = [r for r in pool.map(one, evaluation_paths) if r is not None]
    if len(results) < len(evaluation_paths):
        logger.warning("%d/%d patients failed and were skipped", len(evaluation_paths) - len(results),
                       len(evaluation_paths))
    grouped: Dict[ScanType, Dict[str, List[np.ndarray]]] = defaultdict(lambda: defaultdict(list))
    for label, by_region in results:
        for region, vals in by_region.items():
            grouped[ScanType(label)][region].append(vals)
    out = {st: {region: np.concatenate(vs) for region, vs in d.items()} for st, d in grouped.items()}
    for st, d in out.items():
        for region, vals in d.items():
            logger.info("%s: %d voxels under %r", st.name, len(vals), region)
    return out


def summarize_hu_shift(voxels: Dict[ScanType, Dict[str, np.ndarray]]) -> Dict[str, Dict[str, float]]:
    """Per ``"<ScanType>/<region>"``: mean, std and median HU and the voxel
    count (None for an empty region: NaN is not valid JSON)."""
    out: Dict[str, Dict[str, float]] = {}
    for st, by_region in voxels.items():
        for region, vals in by_region.items():
            vals = np.asarray(vals, np.float64)
            out[f"{st.name}/{region}"] = {
                "mean": float(vals.mean()) if vals.size else None,
                "std": float(vals.std()) if vals.size else None,
                "median": float(np.median(vals)) if vals.size else None,
                "n": int(vals.size),
            }
    return out
