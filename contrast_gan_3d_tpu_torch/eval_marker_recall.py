"""Marker recall as a command (the port's counterpart of the JAX package's
``scripts/eval_marker_recall.py``):

    python -m contrast_gan_3d_tpu_torch.eval_marker_recall tracked/ \\
        annotations/ annotations/labels.csv recall.json

Scores each annotated marker against the centerlines a tracker extracted
(``eval/marker_recall_rate.py``) and writes the JAX command's JSON:
``per_scan_type`` (recall per ScanType and artery) and ``summary``
(optimal against sub-optimal). The labels sheet is csv with ``ID`` and
``label`` columns (``.xlsx`` needs openpyxl and raises). Host numpy only.
"""

import argparse
import json
import logging
import sys
from pathlib import Path

from contrast_gan_3d_tpu_torch.data.labeling import read_sheet
from contrast_gan_3d_tpu_torch.eval.marker_recall_rate import (
    eval_model_marker_recall_rate,
    read_ASOCA_annotations,
    read_IDR_CADRADS_annotations,
    summarize_marker_recall_rate,
)

logger = logging.getLogger("contrast_gan_3d_tpu_torch.eval_marker_recall")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("centerlines_root", type=Path)
    p.add_argument("annotations_root", type=Path)
    p.add_argument("labels_sheet", type=Path, help="csv with ID + label columns")
    p.add_argument("out_json", type=Path)
    p.add_argument("--annotations", choices=["idr_cadrads", "asoca"], default="idr_cadrads")
    p.add_argument("--workers", type=int, default=8)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the command in-process; returns the JSON payload."""
    args = parse_args(argv)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(name)s | %(levelname)s | %(message)s")
    reader = read_IDR_CADRADS_annotations if args.annotations == "idr_cadrads" else read_ASOCA_annotations
    distances, metrics = eval_model_marker_recall_rate(args.centerlines_root, args.annotations_root,
                                                       read_sheet(args.labels_sheet), workers=args.workers,
                                                       annot_read_fn=reader)
    payload = {"per_scan_type": {st.name: m for st, m in metrics.items()},
               "summary": summarize_marker_recall_rate(distances)}
    args.out_json.parent.mkdir(parents=True, exist_ok=True)
    args.out_json.write_text(json.dumps(payload, indent=2))
    logger.info("Marker recall: %s", json.dumps(payload))
    return payload


if __name__ == "__main__":
    main()
    sys.exit(0)
