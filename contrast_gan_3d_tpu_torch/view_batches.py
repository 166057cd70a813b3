"""A look at the loaders' batches (the port's counterpart of the JAX
package's ``scripts/view_batches.py``):

    python -m contrast_gan_3d_tpu_torch.view_batches splits.pkl out/ \\
        --patch-size 128 128 128 --batch-size 2 [--augment] [--interactive]

Reads the first train fold of a cross-validation pickle (``{"train":
[fold, ...], ...}``, a fold ``[(patient path, label), ...]``), draws one
batch per ScanType present through the port's sampler (seed 0) and writes
``<out_dir>/batch_<LABEL>.png``: the first sample's axial slices (at most
16) with its centerline mask, at dpi 110. ``--augment`` first applies the
device augmentation (``data/augment.py``, default ``AugmentConfig``, draws
from a generator seeded 0) on ``--device``, the card by default;
``--interactive`` opens a scrollable window per batch
(``utils/batch_viewer.view_batch``, which needs a display) instead of
writing PNGs. The figures need matplotlib.
"""

import argparse
import logging
import pickle
import sys
from pathlib import Path

import numpy as np
import torch

from contrast_gan_3d_tpu_torch.constants import ScanType
from contrast_gan_3d_tpu_torch.data import augment as aug
from contrast_gan_3d_tpu_torch.data.pipeline import create_loaders
from contrast_gan_3d_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("contrast_gan_3d_tpu_torch.view_batches")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("cval_splits", type=Path)
    p.add_argument("out_dir", type=Path)
    p.add_argument("--patch-size", type=int, nargs="+", default=(128, 128, 128))
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--augment", action="store_true")
    p.add_argument("--interactive", action="store_true",
                   help="open a scrollable BatchViewer window per batch (needs a display) instead of writing PNG "
                        "grids")
    p.add_argument("--device", default="cuda", help="where --augment runs (cpu or cuda)")
    return p.parse_args(argv)


def main(argv=None) -> list:
    """Run the command in-process; returns the PNG paths written."""
    args = parse_args(argv)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(name)s | %(levelname)s | %(message)s")
    args.out_dir.mkdir(parents=True, exist_ok=True)
    device = resolve_device(args.device) if args.augment else None
    with open(args.cval_splits, "rb") as fd:
        fold = pickle.load(fd)["train"][0]
    loaders = create_loaders(fold, tuple(args.patch_size), {st.value: args.batch_size for st in ScanType},
                             np.random.default_rng(0), num_threads=1, prefetch=1, to_device=False)
    written = []
    # a small fold may lack a ScanType: only its labels have loaders
    for label in sorted(loaders):
        st = ScanType(label)
        batch = loaders[label].sampler.next_batch()
        data = batch["data"].astype(np.float32)
        seg = batch["seg"].astype(np.float32)
        if args.augment:
            cfg = aug.AugmentConfig()
            draws = aug.draw(torch.Generator(device=device).manual_seed(0), len(data), cfg)
            data, seg = aug.augment_batch(torch.as_tensor(data, device=device), torch.as_tensor(seg, device=device),
                                          draws, cfg)
            data, seg = data.cpu().numpy(), seg.cpu().numpy()
        if args.interactive:
            from contrast_gan_3d_tpu_torch.utils.batch_viewer import view_batch

            view_batch(data, seg, titles=[f"{st.name} {batch['name'][0]}", "centerline mask"])
            continue
        from contrast_gan_3d_tpu_torch.utils import visualization as viz

        fig = viz.plot_axial_slices(data[0], mask=seg[0], max_slices=16, title=f"{st.name} {batch['name'][0]}")
        out = args.out_dir / f"batch_{st.name}.png"
        fig.savefig(out, dpi=110)
        viz.close(fig)
        logger.info("Wrote %s", out)
        written.append(out)
    return written


if __name__ == "__main__":
    main()
    sys.exit(0)
