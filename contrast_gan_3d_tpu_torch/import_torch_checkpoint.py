"""Turn a REFERENCE torch checkpoint (``<iteration>.pt``) into a port run
checkpoint (counterpart of the JAX package's
``scripts/import_torch_checkpoint.py``):

    python -m contrast_gan_3d_tpu_torch.import_torch_checkpoint 2000.pt runs/ref   # on the card
    python -m contrast_gan_3d_tpu_torch.import_torch_checkpoint 2000.pt runs/ref --device cpu

The reference writes ``torch.save({"iteration", "generator", "optimizer_G",
..., "discriminator"})`` (reference ``trainer/Trainer.py:321-327``; its
``discriminator`` entry is None: the critic was never saved). The
generator's weights and BatchNorm statistics, and the critic's where the
file has one (``utils/reference_checkpoint.load_reference_checkpoint``),
go into networks built from the flags, the generator with
``tconv_placement="torch"``; without a critic in the file the critic stays
freshly initialised (a note says so). The optimizers start fresh (Adam,
no moments yet: torch's moments do not carry across the layout mapping
meaningfully), the step is the file's ``iteration``, and no random
generator state is written, so the run resumes on any device.
``<out_dir>/<iteration>.pt`` is written by ``trainer/checkpoint.
save_checkpoint`` with the ``<iteration>.meta.json`` sidecar
``{"generator": {"tconv_placement": "torch", "norm": ...}}``, from which
``CCTAContrastCorrector.from_checkpoint`` rebuilds the generator, and
which ``train``'s resume and ``load_checkpoint`` read as any port run.
The networks are built on the card unless ``--device cpu``.
"""

import argparse
import sys
from functools import partial
from pathlib import Path

from contrast_gan_3d_tpu_torch.models.discriminator import PatchGANDiscriminator
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.trainer import checkpoint as ckpt_lib
from contrast_gan_3d_tpu_torch.trainer.optim import make_optimizer
from contrast_gan_3d_tpu_torch.trainer.steps import init_state
from contrast_gan_3d_tpu_torch.utils.device import resolve_device
from contrast_gan_3d_tpu_torch.utils.reference_checkpoint import load_reference_checkpoint

NO_CRITIC_NOTE = ("NOTE: no critic in the reference checkpoint (its known save bug) — critic stays freshly "
                  "initialized")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("pt_path", type=Path, help="reference <iteration>.pt file")
    p.add_argument("out_dir", type=Path, help="checkpoint directory for the port's <iteration>.pt")
    p.add_argument("--n-resnet-blocks", type=int, default=4)
    p.add_argument("--n-updownsample-blocks", type=int, default=2)
    p.add_argument("--init-channels-out", type=int, default=16)
    p.add_argument("--critic-init-channels", type=int, default=8)
    p.add_argument("--discriminator-depth", type=int, default=3)
    p.add_argument("--patch", type=int, nargs="+", default=(128, 128, 128),
                   help="a patch size: its length is the networks' ndim")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu: the device that builds the state")
    return p.parse_args(argv)


def main(argv=None) -> Path:
    """Run the command in-process; returns the written checkpoint's path."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    ndim = len(args.patch)
    payload = load_reference_checkpoint(args.pt_path, args.n_resnet_blocks, args.n_updownsample_blocks,
                                        args.discriminator_depth)
    gen = ResnetGenerator(n_resnet_blocks=args.n_resnet_blocks, n_updownsample_blocks=args.n_updownsample_blocks,
                          init_channels_out=args.init_channels_out, ndim=ndim, tconv_placement="torch")
    critic = PatchGANDiscriminator(init_channels_out=args.critic_init_channels,
                                   discriminator_depth=args.discriminator_depth, ndim=ndim)
    gen.load_state_dict(payload["generator"], strict=True)
    if payload["critic"] is not None:
        critic.load_state_dict(payload["critic"], strict=True)
    else:
        print(NO_CRITIC_NOTE)
    tx = partial(make_optimizer, "adam")
    state = init_state(gen, critic, tx, tx, device=device)
    state.step = payload["iteration"]
    path = ckpt_lib.save_checkpoint(
        state, args.out_dir, step=payload["iteration"], rng=False,
        # from_checkpoint rebuilds the generator with the torch placement
        # from this; the default "same" placement would load the same
        # weights and shift the transpose convs' outputs by one voxel
        meta={"generator": {"tconv_placement": "torch", "norm": gen.norm}},
    )
    print(f"wrote {path} (iteration {payload['iteration']})")
    return path


if __name__ == "__main__":
    main()
    sys.exit(0)
