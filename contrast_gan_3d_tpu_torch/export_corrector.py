"""Export a trained corrector as a correction artifact (the port's
counterpart of the JAX package's ``scripts/export_corrector.py``):

    python -m contrast_gan_3d_tpu_torch.export_corrector runs/exp1 out/bundle \\
        --shape 512 512 128 --shape 512 512 192

loads a generator (a run directory or its ``<step>.pt``; a reference
``<iteration>.pt`` with ``--reference-pt``), builds the sliding-window
corrector (``z_bucket`` 0) and traces the whole correction of each volume
shape with ``torch.export`` (``eval/export.py``): one ``--shape`` writes
``<out>.pt2corr`` and its ``.json`` sidecar, several write a bundle
directory ``<out>/corrector_<W>x<H>x<D>.pt2corr`` that ``serve --artifact``
serves as one corrector. The artifact runs on the device it was exported on
(``--device``, the card by default) and loads onto another.
"""

import argparse
from pathlib import Path

import torch

from contrast_gan_3d_tpu_torch.eval.corrector import CCTAContrastCorrector
from contrast_gan_3d_tpu_torch.eval.export import save_exported_corrector
from contrast_gan_3d_tpu_torch.utils.device import resolve_device

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
IN_DTYPES = {"int16": torch.int16, "float32": torch.float32}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("checkpoint", help="run dir or <step>.pt, or a reference .pt with --reference-pt")
    p.add_argument("out", type=Path, help="artifact path (suffix .pt2corr appended); with several --shape, a bundle "
                                          "directory of one artifact per shape")
    p.add_argument("--shape", type=int, nargs=3, required=True, action="append", metavar=("W", "H", "D"),
                   help="volume shape the artifact serves (repeat for a bundle of z buckets)")
    p.add_argument("--reference-pt", action="store_true", help="checkpoint is a reference torch .pt file")
    p.add_argument("--patch", type=int, nargs="+", default=(128, 128, 128),
                   help="inference patch size: W H D (3D sliding window) or W H (2D family, slice-batched)")
    p.add_argument("--overlap", type=float, default=0.25)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--dtype", choices=tuple(DTYPES), default="bfloat16")
    p.add_argument("--in-dtype", choices=tuple(IN_DTYPES), default="int16",
                   help="dtype the artifact accepts (int16 = on-disk HU)")
    p.add_argument("--device", default="cuda", help="device to export on: cuda (default) or cpu")
    args = p.parse_args(argv)
    if len(args.patch) not in (2, 3):
        p.error("--patch takes W H D (3D) or W H (2D)")
    return args


def main(argv=None) -> list:
    """Run the command in-process; returns the artifact paths written."""
    args = parse_args(argv)
    kwargs = dict(inference_patch_size=tuple(args.patch), overlap=args.overlap, batch_size=args.batch,
                  dtype=DTYPES[args.dtype], z_bucket=0, device=resolve_device(args.device))
    if args.reference_pt:
        corrector = CCTAContrastCorrector.from_reference_checkpoint(args.checkpoint, **kwargs)
    else:
        corrector = CCTAContrastCorrector.from_checkpoint(args.checkpoint, **kwargs)
    extra_meta = {"checkpoint": str(args.checkpoint), "patch_size": list(args.patch), "overlap": args.overlap,
                  "compute_dtype": args.dtype}
    shapes = [tuple(s) for s in args.shape]
    written = []
    for shape in shapes:
        out = args.out / ("corrector_%dx%dx%d" % shape) if len(shapes) > 1 else args.out
        path = save_exported_corrector(out, corrector, shape, in_dtype=IN_DTYPES[args.in_dtype],
                                       extra_meta=extra_meta)
        print(f"wrote {path} ({path.stat().st_size / 1e6:.1f} MB) + {path.name}.json", flush=True)
        written.append(path)
    return written


if __name__ == "__main__":
    main()
