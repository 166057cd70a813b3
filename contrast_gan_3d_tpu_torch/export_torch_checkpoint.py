"""Turn a run checkpoint into a REFERENCE torch ``.pt`` (counterpart of the
JAX package's ``scripts/export_torch_checkpoint.py``; the inverse of
``import_torch_checkpoint``):

    python -m contrast_gan_3d_tpu_torch.export_torch_checkpoint runs/exp1 exp1.pt   # the latest <step>.pt
    python -m contrast_gan_3d_tpu_torch.export_torch_checkpoint runs/exp1 exp1.pt --iteration 2000 --device cpu

reads a port ``<step>.pt`` (the file, or a run directory's
``--iteration`` or latest one), or a JAX run's ``<step>.msgpack`` (read
without JAX, as the port's other entry points read one), and writes the
``torch.save`` layout the reference expects (reference
``trainer/Trainer.py:321-327``), so its eval stack (reference
``eval/CCTAContrastCorrector.py:55-56`` reads ``ckpt["generator"]``) runs
generators trained here. The critic is written under
``critic_state_dict`` unless ``--no-critic``: the reference Trainer's
resume tolerates that key, and would crash on a non-None
``discriminator`` entry, which stays None. The block-count flags only
cross-check the checkpoint (a mismatch raises). Before the file is
written the generator is rebuilt from the checkpoint (its architecture
from the weights and the meta sidecar, as ``from_checkpoint`` builds it)
on the card unless ``--device cpu``, and loads the weights strictly.

A file the reference reproduces exactly needs a run with
``tconv_placement="torch"`` (one imported from the reference and
fine-tuned, say): the "same" placement, the training default, places the
transpose convs' windows one voxel off torch's.
"""

import argparse
import sys
from pathlib import Path

from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.models.utils import derive_generator_arch
from contrast_gan_3d_tpu_torch.trainer import checkpoint as ckpt_lib
from contrast_gan_3d_tpu_torch.utils.device import resolve_device
from contrast_gan_3d_tpu_torch.utils.reference_checkpoint import save_reference_checkpoint


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("checkpoint", type=Path, help="<step>.pt / <step>.msgpack file or checkpoint dir")
    p.add_argument("out_path", type=Path, help="output .pt file")
    p.add_argument("--iteration", type=int, default=None, help="checkpoint step to export when a dir is given")
    p.add_argument("--n-resnet-blocks", type=int, default=None,
                   help="cross-check only (derived from the checkpoint)")
    p.add_argument("--n-updownsample-blocks", type=int, default=None,
                   help="cross-check only (derived from the checkpoint)")
    p.add_argument("--discriminator-depth", type=int, default=None,
                   help="cross-check only (derived from the checkpoint)")
    p.add_argument("--no-critic", action="store_true", help="export the generator only")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu: the device the generator is rebuilt on to check the weights")
    return p.parse_args(argv)


def main(argv=None) -> Path:
    """Run the command in-process; returns the written file's path."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    nets = ckpt_lib.load_networks(args.checkpoint, args.iteration)
    arch = {**derive_generator_arch(nets["generator"]), **nets["meta"].get("generator", {})}
    ResnetGenerator(**arch).to(device).load_state_dict(nets["generator"], strict=True)
    critic = None if args.no_critic else nets["critic"]
    args.out_path.parent.mkdir(parents=True, exist_ok=True)
    save_reference_checkpoint(args.out_path, nets["generator"], critic, iteration=nets["step"],
                              n_resnet_blocks=args.n_resnet_blocks,
                              n_updownsample_blocks=args.n_updownsample_blocks,
                              discriminator_depth=args.discriminator_depth)
    print(f"wrote {args.out_path} (iteration {nets['step']}, critic={'no' if critic is None else 'yes'})")
    return args.out_path


if __name__ == "__main__":
    main()
    sys.exit(0)
