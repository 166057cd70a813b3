"""Correct scan files with a trained generator (the port's counterpart of the
JAX package's ``scripts/correct_scans.py``):

    python -m contrast_gan_3d_tpu_torch.correct_scans runs/exp1 out/ a.mhd b.nii.gz p.npy

loads the latest ``<step>.pt`` in the checkpoint directory (or
``--iteration``'s), or a JAX run's ``<step>.msgpack`` where the directory
holds no ``<step>.pt`` (the generator's ``tconv_placement`` and ``norm``
from its ``<step>.meta.json``), or with ``--reference-pt`` the reference
``<iteration>.pt`` file given in its place, builds the generator from it, and writes each corrected
scan as ``<out_dir>/<name>.<format>`` (.mhd with a compressed .raw, .nii,
.nii.gz, or .h5 with ``--output-format h5``; the scans may be HDF5 scans,
patients or corpus members ``corpus.h5::name`` too), in f32 as the JAX command does, the host I/O overlapped with the
correction. Runs on the card unless ``--device cpu``, with cuDNN held to
its deterministic algorithms: its transpose convolutions otherwise may sum
in another order from one call to the next, and a scan corrected twice, or
by the overlapped and the sequential cohort, would not give the same file.
The corrector's default layout is the JAX command's ("auto": the packed
sliding window for a 3D batch-norm generator, batch 24; otherwise direct,
batch 8). ``--sharded`` splits each volume's patch grid over every
visible card (``CCTAContrastCorrector.shard_over``; on the CPU, one
share). The first SIGTERM or Ctrl-C finishes the volumes in flight and
exits 0; a second one aborts. HDF5 needs h5py, which the card's machine
lacks: an ``.h5`` path there raises ``ImportError``.
"""

import argparse
import logging
import signal
import sys
import threading
from pathlib import Path

import torch

from contrast_gan_3d_tpu_torch.eval.corrector import CCTAContrastCorrector
from contrast_gan_3d_tpu_torch.eval.utils import correct_patients
from contrast_gan_3d_tpu_torch.parallel.inference import local_devices
from contrast_gan_3d_tpu_torch.utils.device import resolve_device
from contrast_gan_3d_tpu_torch.utils.signals import install_graceful_stop

logger = logging.getLogger("contrast_gan_3d_tpu_torch.correct_scans")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("checkpoint_dir", type=Path)
    p.add_argument("out_dir", type=Path)
    p.add_argument("scans", nargs="+", help="scan files or preprocessed patients")
    p.add_argument("--iteration", type=int, default=None)
    p.add_argument("--patch-size", type=int, nargs=3, default=(128, 128, 128))
    p.add_argument("--overlap", type=float, default=0.5)
    p.add_argument("--batch-size", type=int, default=None,
                   help="generator forward batch (default: the corrector's layout-aware choice, 24 packed / 8 direct)")
    p.add_argument("--reference-pt", action="store_true",
                   help="checkpoint is a reference torch .pt file (architecture read from its state_dict)")
    p.add_argument("--sharded", action="store_true",
                   help="split each volume's patch grid over every visible card (keeps the layout)")
    p.add_argument("--output-format", choices=("mhd", "nii", "nii.gz", "h5"), default="mhd",
                   help="corrected-scan format (h5 needs h5py, which the card's machine lacks)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.reference_pt and args.iteration is not None:
        p.error("--iteration applies to checkpoint dirs; a --reference-pt file is one iteration")
    return args


def main(argv=None) -> list:
    """Run the command in-process; returns the paths written."""
    args = parse_args(argv)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(name)s | %(levelname)s | %(message)s")
    device = resolve_device(args.device)
    kwargs = dict(inference_patch_size=tuple(args.patch_size), overlap=args.overlap, batch_size=args.batch_size,
                  device=device)
    if args.reference_pt:
        corrector = CCTAContrastCorrector.from_reference_checkpoint(args.checkpoint_dir, **kwargs)
    else:
        corrector = CCTAContrastCorrector.from_checkpoint(args.checkpoint_dir, iteration=args.iteration, **kwargs)
    if args.sharded:
        corrector.shard_over(local_devices(device))
        logger.info("Patch grid sharded over %d device(s)", len(corrector.devices))
    stop = threading.Event()
    previous = install_graceful_stop(lambda name: stop.set(), stop.is_set)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        done = correct_patients(corrector, args.out_dir, args.scans, suffix=f".{args.output_format}",
                                stop_requested=stop.is_set)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        for signum, handler in (previous or {}).items():
            signal.signal(signum, handler)
    if stop.is_set():
        logger.warning("Stopped early: %d/%d scans corrected", len(done), len(args.scans))
    return done


if __name__ == "__main__":
    main()
    sys.exit(0)
