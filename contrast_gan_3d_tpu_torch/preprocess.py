"""Turn a dataset root of raw CCTA scans into packed patients (the port's
counterpart of the JAX package's ``scripts/preprocess.py``):

    python -m contrast_gan_3d_tpu_torch.preprocess raw/ patients/ --out-spacing 0.5

Expected layout per patient (ASOCA/MMWHS style):
  <root>/<name>.mhd (or .nii.gz)           the scan
  <root>/<name>/vessel[0-9]*.txt           centerline point clouds
  <root>/<name>/ostia.xml                  MeVisLab ostia markers

Each scan becomes ``<out_dir>/<name>.npy`` + ``<name>_meta.pkl``
(``data/preprocess.create_patient``), what the train CLI's splits name;
``--format h5`` writes a standalone ``<name>.h5`` each, and an ``out_dir``
ending in ``.h5`` packs every patient into that one corpus file
(``data/hdf5.py``; both need h5py, which the card's machine lacks).
``--h5-chunks`` sets the HDF5 chunk shape (z-thin, e.g. ``64 64 1 2``, for
corpora the 2D slice samplers read). ``--out-spacing`` resamples on the
card unless ``--device cpu``. A scan without its centerline folder or
ostia file is skipped with a warning; a scan that fails is logged and the
others go on. ``--shard I/N`` runs one of N jobs: give each its own corpus
file (a corpus file has one writer at a time).
"""

import argparse
import logging
import sys
from pathlib import Path

from contrast_gan_3d_tpu_torch.data.preprocess import create_patient
from contrast_gan_3d_tpu_torch.utils.device import resolve_device
from contrast_gan_3d_tpu_torch.utils.io_utils import stem

logger = logging.getLogger("contrast_gan_3d_tpu_torch.preprocess")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("root", type=Path, help="dataset root")
    p.add_argument("out_dir", type=Path, help="output directory for patients, or a .h5 corpus file for all of them")
    p.add_argument("--glob", default="*.mhd", help="scan file glob")
    p.add_argument("--format", choices=("npy", "h5"), default="npy",
                   help="per-patient storage: .npy + pickle, or standalone HDF5 (a .h5 out_dir is a corpus either way)")
    p.add_argument("--out-spacing", type=float, nargs="+", default=None, metavar="MM",
                   help="resample scans to this spacing (1 value = isotropic, or 3 per-axis mm) before packing; "
                        "default keeps native spacing like the reference")
    p.add_argument("--h5-chunks", type=int, nargs=4, default=None, metavar=("CX", "CY", "CZ", "CC"),
                   help="HDF5 chunk shape (default 64 64 64 C); 2D slice corpora want z-thin chunks, e.g. 64 64 1 2")
    p.add_argument("--shard", default=None, metavar="I/N", help="process only scans[i::n]")
    p.add_argument("--device", default="cuda", help="where --out-spacing resamples: cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.h5_chunks is not None and args.format != "h5" and args.out_dir.suffix.lower() not in (".h5", ".hdf5"):
        # .npy patients have no chunks: a silent no-op would leave a cohort
        # its user believes slice-read-optimised
        p.error("--h5-chunks needs --format h5 or a .h5 corpus out_dir (.npy patients are not chunked)")
    if args.out_spacing is not None and len(args.out_spacing) not in (1, 3):
        p.error(f"--out-spacing takes 1 or 3 values, got {len(args.out_spacing)}")
    args.shard_of = None
    if args.shard:
        try:
            i, n = (int(v) for v in args.shard.split("/"))
        except ValueError:
            p.error(f"--shard {args.shard!r}: expected I/N, e.g. 0/4")
        if not 0 <= i < n:
            p.error(f"--shard {args.shard}: need 0 <= i < n")
        args.shard_of = (i, n)
    return args


def main(argv=None) -> list:
    """Run the command in-process; returns the patients' paths (``.npy``,
    ``.h5`` or ``corpus.h5::name``)."""
    args = parse_args(argv)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(name)s | %(levelname)s | %(message)s")
    device = resolve_device(args.device)
    out_spacing = args.out_spacing
    if out_spacing is not None and len(out_spacing) == 1:
        out_spacing = out_spacing[0]
    scans = sorted(args.root.glob(args.glob))
    logger.info("Found %d scans under %s", len(scans), args.root)
    if args.shard_of is not None:
        i, n = args.shard_of
        scans = scans[i::n]
        logger.info("Shard %d/%d: %d scans", i, n, len(scans))
    written, failures = [], []
    for scan in scans:
        # io_utils.stem, not Path.stem: a '.nii.gz' scan keeps '.nii' under
        # Path.stem, and its '<name>/' centerline folder would not be found
        pdir = scan.parent / stem(scan)
        ostia = pdir / "ostia.xml"
        if not pdir.is_dir() or not ostia.is_file():
            logger.warning("Skipping %s: missing centerlines dir or ostia.xml", scan)
            continue
        try:
            written.append(create_patient(scan, pdir, ostia, args.out_dir, out_spacing=out_spacing, fmt=args.format,
                                          h5_chunks=tuple(args.h5_chunks) if args.h5_chunks else None,
                                          device=device))
        except Exception as e:  # one bad scan must not stop the batch
            logger.exception("FAILED %s: %s", scan, e)
            failures.append(scan)
    if failures:
        logger.error("%d failures: %s", len(failures), [str(f) for f in failures])
    return written


if __name__ == "__main__":
    main()
    sys.exit(0)
