"""Marker recall (the port's counterpart of
``contrast_gan_3d_tpu/eval/marker_recall_rate.py``): after a centerline
tracker re-extracts centerlines from corrected scans, each annotated
coronary marker (IDR_CADRADS LAD / LCX / RCA, four each, or ASOCA
annotations) is scored by its distance to the nearest extracted point;
recall is the share within 5 mm. Aggregated per ScanType and as optimal
against sub-optimal. Host numpy in float64, as in the JAX package, so the
threshold cuts the same markers; patients fan out over a thread pool.
Labels come from a sheet's rows (``data/labeling.read_sheet``), not a
DataFrame."""

import logging
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple

import numpy as np

from contrast_gan_3d_tpu_torch.constants import ScanType
from contrast_gan_3d_tpu_torch.utils import geometry as geom
from contrast_gan_3d_tpu_torch.utils import io_utils

logger = logging.getLogger(__name__)

RECALL_THRESHOLD_MM = 5.0


def read_ASOCA_annotations(patient_dir: Path) -> Dict[str, np.ndarray]:
    return {"centerlines": io_utils.load_ASOCA_annotated_centerlines(patient_dir)}


def read_IDR_CADRADS_annotations(patient_dir: Path) -> Dict[str, np.ndarray]:
    """The LAD / LCX / RCA marker files of a patient, 4 markers each (a
    missing file is skipped, a short one warned about)."""
    out = {}
    for artery in ["LAD", "LCX", "RCA"]:
        fname = Path(patient_dir) / f"{artery}.txt"
        if not fname.is_file():
            logger.warning("Skip missing annotation %r", str(fname))
            continue
        annots = np.loadtxt(fname, ndmin=2)
        if len(annots) != 4:
            logger.warning("%r has only %d annotations", str(fname), len(annots))
        out[artery] = annots
    return out


def marker_recall_rate(distance_to_marker: np.ndarray, threshold: float = RECALL_THRESHOLD_MM) -> float:
    """The share of markers within ``threshold`` mm of an extracted
    centerline; NaN for an empty array ('no marker scored', not 0)."""
    distance_to_marker = np.asarray(distance_to_marker)
    if len(distance_to_marker) == 0:
        return float("nan")
    return float((distance_to_marker <= threshold).sum() / len(distance_to_marker))


def find_closest_centerlines_to_annotations(
    annotations_dir, centerlines_dir,
    annot_read_fn: Callable[[Path], Dict[str, np.ndarray]] = read_IDR_CADRADS_annotations,
) -> Dict[str, Dict[str, np.ndarray]]:
    """{artery: {"z_idx": nearest centerline index, "dist": its distance}}
    per annotated marker."""
    centerlines = io_utils.load_centerlines(centerlines_dir)[..., :3]
    out = {}
    for name, annots in annot_read_fn(Path(annotations_dir)).items():
        annots = np.asarray(annots)[..., :3].reshape(-1, 3)
        if not annots.size or not centerlines.size:
            logger.warning("Missing annotations/centerlines for %r", str(annotations_dir))
            continue
        dists = geom.pointwise_euclidean_distance(centerlines, annots)
        out[name] = {"z_idx": dists.argmin(0), "dist": dists.min(0)}
    return out


def best_match(root, name):
    """The entry of ``root`` named ``name`` (file name or stem), else the
    first sorted entry whose name contains it, with a warning (a substring
    hit can pair patient '1' with patient '10'), else None."""
    hits = sorted(Path(root).glob(f"*{name}*"))
    exact = [h for h in hits if h.name == str(name) or h.stem == str(name)]
    if not exact and hits:
        logger.warning("No exact match for patient %r under %r; falling back to substring hit %r",
                       str(name), str(root), hits[0].name)
    return (exact or hits or [None])[0]


def eval_model_marker_recall_rate(
    centerlines_root_dir, annotations_root_dir, labels: Sequence[Dict], workers: int = 8, **kwargs,
) -> Tuple[Dict, Dict]:
    """Score every patient of the ``labels`` rows (``ID``, ``label``) found
    in both roots; returns (distances, recall) per ScanType and artery.
    Patients missing from either root are excluded from the denominator,
    loudly; a patient whose files fail is skipped, loudly."""
    jobs, missing = [], []
    for row in labels:
        label, name = row["label"], row["ID"]
        ap = best_match(annotations_root_dir, name)
        cp = best_match(centerlines_root_dir, name)
        if ap is not None and cp is not None:
            jobs.append((int(label), ap, cp))
        else:
            missing.append(str(name))
    if missing:
        logger.warning("%d/%d patients have no annotations/centerlines match and are EXCLUDED from the recall "
                       "denominator: %s", len(missing), len(labels), missing)

    def _one(j):
        try:
            return (j[0], find_closest_centerlines_to_annotations(j[1], j[2], **kwargs))
        except Exception as e:
            logger.error("FAILED %r: %s", str(j[2]), e)
            return None

    with ThreadPoolExecutor(max_workers=workers) as pool:
        results = [r for r in pool.map(_one, jobs) if r is not None]
    if len(results) < len(jobs):
        logger.warning("%d/%d patients failed and were skipped", len(jobs) - len(results), len(jobs))

    collected: Dict[int, Dict[str, Dict[str, list]]] = defaultdict(lambda: defaultdict(lambda: defaultdict(list)))
    for label, per_artery in results:
        for artery, dd in per_artery.items():
            for k, v in dd.items():
                collected[label][artery][k].append(v)

    distances: Dict[ScanType, Dict[str, Dict[str, np.ndarray]]] = {}
    metrics: Dict[ScanType, Dict[str, float]] = defaultdict(dict)
    for label, per_artery in collected.items():
        st = ScanType(label)
        distances[st] = {}
        for artery, dd in per_artery.items():
            distances[st][artery] = {k: np.concatenate(v) for k, v in dd.items()}
            metrics[st][artery] = marker_recall_rate(distances[st][artery]["dist"])
    return distances, dict(metrics)


def summarize_marker_recall_rate(
    distances: Dict[ScanType, Dict[str, Dict[str, np.ndarray]]]
) -> Dict[str, Dict[str, float]]:
    """Recall per artery for 'optimal' and for LOW and HIGH pooled as
    'suboptimal'."""
    aggregated: Dict[str, Dict[str, float]] = {"optimal": {}}
    subopt: Dict[str, list] = defaultdict(list)
    for st, per_artery in distances.items():
        for artery, dd in per_artery.items():
            if st in (ScanType.LOW, ScanType.HIGH):
                subopt[artery].append(dd["dist"])
            else:
                aggregated["optimal"][artery] = marker_recall_rate(dd["dist"])
    aggregated["suboptimal"] = {artery: marker_recall_rate(np.concatenate(v)) for artery, v in subopt.items()}
    return aggregated
