"""The HU-distribution-shift evaluation as a command (the port's counterpart
of the JAX package's ``scripts/eval_hu_shift.py``):

    python -m contrast_gan_3d_tpu_torch.eval_hu_shift original_list.json out/ \\
        --tag original --series corrected=corrected_list.json

Each eval list is JSON, ``[[[scan, centerline_dir, myocardium|null],
label], ...]``. For every series it gathers the masked voxel intensities
(``eval/hu_distribution_shift.py``), logs them and writes
``<out_dir>/hu_shift_<tag>.json``: mean, std, median and count per
ScanType and region. Then it draws the KDE comparison figure
(``utils/visualization.hu_distribution_shift_plot``: the centerlines and
ostia regions, one curve per ``<tag>/<ScanType>`` series) into
``hu_shift_<tag>.png``, or ``hu_shift_compare.png`` for more than one
series, at dpi 120. Where matplotlib cannot be imported, the summaries are
written and one warning names it. Host numpy only, no device.
"""

import argparse
import importlib.util
import json
import logging
import sys
from pathlib import Path

from contrast_gan_3d_tpu_torch.eval.hu_distribution_shift import collect_voxels_intensity, summarize_hu_shift

logger = logging.getLogger("contrast_gan_3d_tpu_torch.eval_hu_shift")


def load_eval_list(path):
    """JSON list of [[scan_path, centerline_dir, myocardium_path|null], label]."""
    entries = json.loads(Path(path).read_text())
    return [(tuple(p for p in paths if p is not None), int(label)) for paths, label in entries]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("eval_list", type=Path, help="JSON eval list (see load_eval_list)")
    p.add_argument("out_dir", type=Path)
    p.add_argument("--tag", default="original", help="series name in outputs")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--series", action="append", default=[], metavar="TAG=EVAL_LIST.json",
                   help="an additional series, e.g. --series corrected=corrected_list.json; repeatable. Each "
                        "series gets its own hu_shift_<tag>.json summary")
    args = p.parse_args(argv)
    args.lists = [(args.tag, args.eval_list)]
    for spec in args.series:
        tag, _, path = spec.partition("=")
        if not path:
            p.error(f"--series {spec!r}: expected TAG=EVAL_LIST.json")
        args.lists.append((tag, Path(path)))
    return args


def main(argv=None) -> dict:
    """Run the command in-process; returns {tag: summary}."""
    args = parse_args(argv)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(name)s | %(levelname)s | %(message)s")
    args.out_dir.mkdir(parents=True, exist_ok=True)
    summaries, series = {}, {}
    for tag, eval_list in args.lists:
        voxels = collect_voxels_intensity(load_eval_list(eval_list), args.workers)
        summary = summarize_hu_shift(voxels)
        out_json = args.out_dir / f"hu_shift_{tag}.json"
        out_json.write_text(json.dumps(summary, indent=2))
        logger.info("Wrote %s: %s", out_json, json.dumps(summary))
        summaries[tag] = summary
        series |= {f"{tag}/{st.name}": by_region for st, by_region in voxels.items()}
    if importlib.util.find_spec("matplotlib") is None:
        logger.warning("matplotlib is not installed: no KDE figure (the summaries are written)")
        return summaries
    from contrast_gan_3d_tpu_torch.utils import visualization as viz

    name = f"hu_shift_{args.tag}.png" if len(args.lists) == 1 else "hu_shift_compare.png"
    fig = viz.hu_distribution_shift_plot(series, regions=("centerlines", "ostia"))
    fig.savefig(args.out_dir / name, dpi=120)
    viz.close(fig)
    logger.info("Wrote %s", args.out_dir / name)
    return summaries


if __name__ == "__main__":
    main()
    sys.exit(0)
