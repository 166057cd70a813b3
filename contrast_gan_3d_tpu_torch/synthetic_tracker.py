"""The intensity-threshold centerline "tracker" of the synthetic cohort (the
port's counterpart of the JAX package's ``scripts/synthetic_tracker.py``):

    python -m contrast_gan_3d_tpu_torch.synthetic_tracker original_list.json \\
        tracked/ --annotations-out annotations/

A stand-in for the external CNN coronary tracker the reference wraps: the
tracked points of a scan are its voxels above ``--threshold`` HU (300 by
default, between the ~250 HU under-enhanced synthetic vessels and the
350-450 HU corridor), so the marker recall it feeds measures whether
correction makes vessels trackable. The threshold runs on the card unless
``--device cpu``: ``torch.nonzero`` lists the voxels in ``np.argwhere``'s
C order, and the subsample draws the JAX script's
``np.random.default_rng(seed).choice`` calls in its order, so the points
are the JAX script's, bit for bit.

Input: an ``eval_hu_shift`` cohort list (``[[scan, centerline_dir,
myocardium|null], label]``, as ``validate_learning --eval-cohort`` writes
it). Each scan gets ``<out_root>/<name>/vessel0.txt`` (rows ``x y z
radius``, world mm). ``--annotations-out`` also derives IDR_CADRADS-style
markers (``<name>/{LAD,LCX,RCA}.txt``, 4 each) from each entry's
ground-truth centerline directory and a ``labels.csv`` (``ID,label``)
sheet: the other two inputs of ``eval_marker_recall``.
"""

import argparse
import csv
import json
import logging
import math
import sys
from pathlib import Path

import numpy as np
import torch

from contrast_gan_3d_tpu_torch.utils import geometry as geom
from contrast_gan_3d_tpu_torch.utils import io_utils
from contrast_gan_3d_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("contrast_gan_3d_tpu_torch.synthetic_tracker")


def track_scan(scan_path, threshold: float, max_points: int, rng, device="cuda") -> np.ndarray:
    """(N, 4) world ``x y z radius`` points: the scan's voxels above
    ``threshold`` HU in C order, subsampled to ``max_points`` with
    ``rng.choice``; (0, 4) when nothing tracks."""
    vol, meta = io_utils.load_scan(scan_path)
    # an int16 voxel lies above the threshold iff it lies above its floor:
    # exact whatever dtype the comparison promotes to
    ijk = torch.nonzero(torch.from_numpy(vol).to(resolve_device(device)) > math.floor(threshold))
    if len(ijk) == 0:
        return np.zeros((0, 4), np.float64)
    if len(ijk) > max_points:
        pick = rng.choice(len(ijk), size=max_points, replace=False)
        ijk = ijk[torch.from_numpy(pick).to(ijk.device)]
    world = geom.image_to_world_coords(ijk.cpu().numpy().astype(np.float64), meta["offset"], meta["spacing"])
    return np.concatenate([world, np.full((len(world), 1), 1.0)], axis=1)


def derive_annotations(gt_centerline_dir, out_dir: Path) -> None:
    """LAD / LCX / RCA marker files from a ground-truth centerline dir: the
    polyline split in thirds, 4 evenly spaced markers each."""
    pts = io_utils.load_centerlines(gt_centerline_dir)[..., :3]
    out_dir.mkdir(parents=True, exist_ok=True)
    thirds = np.array_split(np.arange(len(pts)), 3)
    for artery, idx in zip(("LAD", "LCX", "RCA"), thirds):
        take = idx[np.linspace(0, len(idx) - 1, 4).round().astype(int)]
        np.savetxt(out_dir / f"{artery}.txt", pts[take])


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("cohort_list", type=Path,
                   help="eval_hu_shift-format JSON list ([[scan, centerline_dir, myo|null], label])")
    p.add_argument("out_root", type=Path, help="tracked centerlines written to <out_root>/<name>/")
    p.add_argument("--threshold", type=float, default=300.0, help="HU track threshold")
    p.add_argument("--max-points", type=int, default=2000)
    p.add_argument("--annotations-out", type=Path, default=None,
                   help="also derive <name>/{LAD,LCX,RCA}.txt marker annotations from each entry's ground-truth "
                        "centerline dir and a labels.csv sheet")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the command in-process; returns the JSON summary, with the
    tracked points per scan name under ``points`` (not printed)."""
    args = parse_args(argv)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(name)s | %(levelname)s | %(message)s")
    device = resolve_device(args.device)
    cohort = json.loads(args.cohort_list.read_text())
    rng = np.random.default_rng(args.seed)
    labels, points = [], {}
    for (scan, gt_ctl_dir, _myo), label in cohort:
        name = io_utils.stem(scan)
        pts = track_scan(scan, args.threshold, args.max_points, rng, device=device)
        pdir = args.out_root / name
        pdir.mkdir(parents=True, exist_ok=True)
        np.savetxt(pdir / "vessel0.txt", pts)
        logger.info("%s: %d voxels tracked above %.0f HU", name, len(pts), args.threshold)
        if args.annotations_out is not None:
            derive_annotations(gt_ctl_dir, args.annotations_out / name)
        labels.append((name, label))
        points[name] = pts
    if args.annotations_out is not None:
        with open(args.annotations_out / "labels.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["ID", "label"])
            w.writerows(labels)
    summary = {"tracked": len(labels), "out_root": str(args.out_root), "threshold": args.threshold}
    print(json.dumps(summary))
    return dict(summary, points=points)


if __name__ == "__main__":
    main()
    sys.exit(0)
