"""Bisect the gradients of a mesh step against one rank's on the CPU
(ROADMAP C9). Not a test module (pytest does not collect it): a command
kept as the origin of the C9 numbers in PERF.md. It imports only the port.

    python tests/mesh_grad_bisect.py
    python tests/mesh_grad_bisect.py --dtypes float32 --patch 64 64 64 --meshes 1x2
    python tests/mesh_grad_bisect.py --family 2d --patch 64 64 --mix 32 16 16 --meshes 1x2

One ``combined_step`` of basic_3d's full-width networks (the direct
generator, 1,035,297 parameters; the critic, batch norm for weight clip
and none for the gradient penalty, as ``chip_smoke.py``'s phase 48 builds
them) from seeded weights on one seeded batch of 6 + 3 + 3 patches, on one
rank and on each mesh (``1x2``: two spatial ranks, each an X-slab;
``2x1``: two data ranks, each half the batch), gloo on this host, every
run under deterministic algorithms, in each dtype (float64 runs the
generator's stem and projection as plain convs: B3 -> B1's plain version
accumulates in f32, as the kernel does). The default patch,
32^3, is the smallest the step takes (the critic's logits need 32 rows).
``--family 2d`` runs conf_2d's networks instead (6 ResNet blocks, the
16-channel critic, ``ndim=2``; the 2D family has no stem kernel) on 2D
slices (``--patch`` of two dims, 32^2 the smallest).
Per run it prints, for each network, the largest ``max |g_mesh - g_one| /
max |g_one|`` over the leaves (the card's gate, ``chip_smoke.py``'s
``DP_GRAD_REL``) and the leaf that reaches it, and the largest relative
difference of the metrics. A gap that float64 closes to its rounding is
float32 rounding amplified by the step; one that stays is a fault.
"""

import argparse
import sys
import tempfile
from functools import partial
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import numpy as np  # noqa: E402
import torch  # noqa: E402

from contrast_gan_3d_tpu_torch.models.discriminator import PatchGANDiscriminator  # noqa: E402
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator  # noqa: E402
from contrast_gan_3d_tpu_torch.parallel.mesh import LOCAL, dp_sp_mesh, spawn_ranks  # noqa: E402
from contrast_gan_3d_tpu_torch.trainer.optim import make_optimizer  # noqa: E402
from contrast_gan_3d_tpu_torch.trainer.steps import StepConfig  # noqa: E402
from contrast_gan_3d_tpu_torch.trainer.trainer import HIGH, LOW, OPT, Trainer, TrainerConfig  # noqa: E402

DTYPES = {"float32": torch.float32, "float64": torch.float64}
MODES = {"wc": dict(norm="batch", lr=2e-4, betas=(0.5, 0.999), weight_clip=0.01),
         "gp": dict(norm=None, lr=1e-4, betas=(0.0, 0.9), weight_clip=None)}
SEED = 15


def patches(patch, mix, seed=48):
    rng = np.random.default_rng(seed)
    n_opt, n_low, n_high = mix
    data = lambda n: rng.integers(-1024, 1500, (n, *patch)).astype(np.int16)
    seg = lambda n: (rng.random((n, *patch)) < 0.001).astype(np.int16)
    return {OPT: {"data": data(n_opt)}, LOW: {"data": data(n_low), "seg": seg(n_low)},
            HIGH: {"data": data(n_high), "seg": seg(n_high)}}


def step(mode: str, dtype: str, batch: dict, mesh=LOCAL) -> dict:
    """One deterministic ``combined_step``: metrics and gradients by
    network and name (conf_2d's networks for 2D slices)."""
    spec, dt = MODES[mode], DTYPES[dtype]
    flat = batch[OPT]["data"].ndim == 3
    torch.manual_seed(SEED)
    # B1's plain version accumulates in f32, as the kernel does: float64
    # takes the stem's and the projection's plain convs (the same function)
    gen_kw = dict(ndim=2, n_resnet_blocks=6) if flat else dict(s2d_factor=4 if dt == torch.float32 else None)
    gen = ResnetGenerator(layout="direct", dtype=dt, **gen_kw).to(dt)
    torch.manual_seed(SEED + 1)
    critic = PatchGANDiscriminator(norm=spec["norm"], dtype=dt, **(dict(ndim=2, init_channels_out=16) if flat
                                                                    else {})).to(dt)
    tx = partial(make_optimizer, "adam", lr=spec["lr"], betas=spec["betas"])
    trainer = Trainer(gen, critic, tx, tx, StepConfig(weight_clip=spec["weight_clip"], dtype=dt),
                      TrainerConfig(), seed=SEED, device="cpu", mesh=mesh)
    torch.use_deterministic_algorithms(True)
    _, metrics = trainer.steps.combined_step(trainer.state, *trainer._assemble(batch)[:3])
    grads = {net: {k: p.grad.detach().clone() for k, p in getattr(trainer.state, net).named_parameters()}
             for net in ("generator", "critic")}
    return dict(metrics={k: float(v) for k, v in metrics.items()}, grads=grads)


def _rank(mode, dtype, batch, shape, out):
    torch.set_num_threads(2)
    mesh = dp_sp_mesh(*shape, device="cpu")
    res = step(mode, dtype, batch, mesh)
    if mesh.rank == 0:
        torch.save(res, out)


def worst(got: dict, want: dict) -> dict:
    """Per network: the largest max |got - want| / max |want| over the
    leaves, and that leaf."""
    out = {}
    for net, leaves in want.items():
        rel = {k: ((got[net][k] - w).abs().max() / w.abs().max()).item() for k, w in leaves.items()
               if w.abs().max() > 0}
        k = max(rel, key=rel.get)
        out[net] = (rel[k], k)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--family", choices=("3d", "2d"), default="3d")
    p.add_argument("--patch", type=int, nargs="+", default=None, help="default 32^3, or 32^2 with --family 2d")
    p.add_argument("--mix", type=int, nargs=3, default=(6, 3, 3))
    p.add_argument("--dtypes", nargs="+", default=["float64", "float32"], choices=sorted(DTYPES))
    p.add_argument("--modes", nargs="+", default=["wc", "gp"], choices=sorted(MODES))
    p.add_argument("--meshes", nargs="+", default=["1x2", "2x1"])
    args = p.parse_args(argv)
    torch.set_num_threads(4)
    if args.patch is None:
        args.patch = [32] * (2 if args.family == "2d" else 3)
    if len(args.patch) != (2 if args.family == "2d" else 3):
        p.error(f"--patch takes {2 if args.family == '2d' else 3} dims for --family {args.family}")
    batch = patches(tuple(args.patch), tuple(args.mix))
    for dtype in args.dtypes:
        for mode in args.modes:
            one = step(mode, dtype, batch)
            for spec in args.meshes:
                shape = tuple(int(v) for v in spec.split("x"))
                with tempfile.TemporaryDirectory() as tmp:
                    out = Path(tmp) / "rank0.pt"
                    spawn_ranks(_rank, shape[0] * shape[1], (mode, dtype, batch, shape, str(out)), backend="gloo",
                                timeout=600)
                    got = torch.load(out, weights_only=False)
                metric = max(abs(got["metrics"][k] - v) / max(abs(v), 1e-30) for k, v in one["metrics"].items())
                gaps = worst(got["grads"], one["grads"])
                print(f"{dtype} {mode} mesh {spec} patch {'x'.join(map(str, args.patch))} mix "
                      f"{'+'.join(map(str, args.mix))}: metrics within {metric:.3e}; gradients "
                      + "; ".join(f"{net} {rel:.3e} ({leaf})" for net, (rel, leaf) in gaps.items()), flush=True)


if __name__ == "__main__":
    main()
