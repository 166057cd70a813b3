"""FLOPs per program of the port's training and inference programs (the
port's counterpart of the JAX package's ``scripts/flops_accounting.py``):

    python -m contrast_gan_3d_tpu_torch.flops_accounting [--json] [--smoke]

The JAX script reads XLA's cost analysis of its compiled programs. Here
each program runs once, eagerly, under ``torch.utils.flop_counter.
FlopCounterMode``, on the card unless ``--device cpu``: the count is the
products and convolutions the program executes (forward, backward and,
for gradient penalty, the double backward), elementwise work excluded,
where XLA's count includes it. The hand-written kernels count through the
flop formulas of their operators (``ops/block_conv.py``): B1 launches
(the input gradient's too) and B3 at the work they execute, with the
model FLOPs of the same 7^3 convs beside them (``model_flops``: the
program's count with each B1 / B3 launch and B1 weight gradient counted
as the plain conv it stands for).

The programs and shapes are the JAX script's: the weight-clip and the
gradient-penalty ``combined_step`` and the ``critic_step`` at 6 + 3 + 3
128^3 patches, bf16, packed generator; the 2D weight-clip
``combined_step`` at 256 + 256 128^2 slices; the packed generator's
forward at batch 24 (f2-packed input, f4-packed output). The direct-layout
counterparts (``*_direct``), which launch B1 and B3, are added. Each
program's ``jax_hlo_tflop`` is the JAX package's recorded XLA count of the
same program (ROUND4.md; a work count, not a time). ``--smoke`` shrinks
shapes and models (the counts then mean nothing).
"""

import argparse
import json
import sys
from functools import partial

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from contrast_gan_3d_tpu_torch.models.discriminator import PatchGANDiscriminator
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.ops import block_conv
from contrast_gan_3d_tpu_torch.trainer.optim import make_optimizer
from contrast_gan_3d_tpu_torch.trainer.steps import StepConfig, build_train_steps, init_state
from contrast_gan_3d_tpu_torch.utils.device import resolve_device

# the JAX package's XLA counts of the same programs, TFLOP (ROUND4.md:52-54)
JAX_HLO_TFLOP = {
    "combined_wc_128c_b12": 5.658,
    "critic_only_128c_b12": 2.020,
    "combined_gp_128c_b12": 5.701,
    "combined_wc_128sq_b512": 0.918,
    "inference_fwd_packed_128c_b24": 7.859,
}
SMOKE_GEN = {"n_resnet_blocks": 1, "init_channels_out": 4}
SMOKE_CRITIC = {"init_channels_out": 4, "discriminator_depth": 2}


def setup_step(use_gp: bool, is_2d: bool, layout: str, device, smoke: bool):
    """(state, steps, (opt, sub, mask)): the JAX script's ``_setup`` in the
    port: bf16 networks, Adam, weight clip 0.01 or gradient penalty, no
    augmentation, seeded int16 batches."""
    if is_2d:
        patch = (32, 32) if smoke else (128, 128)
        gen = ResnetGenerator(ndim=2, dtype=torch.bfloat16, **(SMOKE_GEN if smoke else {"n_resnet_blocks": 6}))
        critic = PatchGANDiscriminator(ndim=2, dtype=torch.bfloat16, **(SMOKE_CRITIC if smoke else {}))
        n = 2 if smoke else 256
    else:
        patch = (16, 16, 16) if smoke else (128, 128, 128)
        gen = ResnetGenerator(dtype=torch.bfloat16, layout=layout, **(SMOKE_GEN if smoke else {}))
        critic = PatchGANDiscriminator(dtype=torch.bfloat16, **(SMOKE_CRITIC if smoke else {}))
        n = 2 if smoke else 6
    tx = partial(make_optimizer, "adam")
    cfg = StepConfig(weight_clip=None if use_gp else 0.01, augment=None, dtype=torch.bfloat16)
    state = init_state(gen, critic, tx, tx, seed=0, device=device)
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(a).to(device)
    opt = t(rng.integers(-1024, 1500, (n, *patch), dtype=np.int16))
    sub = t(rng.integers(-1024, 1500, (n, *patch), dtype=np.int16))
    msk = t((rng.random((n, *patch)) < 0.001).astype(np.int16))
    return state, build_train_steps(cfg), (opt, sub, msk)


def setup_forward(layout: str, device, smoke: bool):
    """(generator, input): the eval-mode bf16 generator and its batch-24
    128^3 input, f2-packed channels-last for the packed layout, NCDHW for
    the direct one."""
    gen = ResnetGenerator(dtype=torch.bfloat16, layout=layout, **(SMOKE_GEN if smoke else {})).to(device).eval()
    pe, b = (16, 2) if smoke else (128, 24)
    if layout == "packed":
        x = torch.zeros((b, pe // 2, pe // 2, pe // 2, 8), dtype=torch.bfloat16, device=device)
        return (lambda: gen.forward_packed(x, packed_input=True, packed_output=True)), gen
    x = torch.zeros((b, 1, pe, pe, pe), dtype=torch.bfloat16, device=device)
    return (lambda: gen(x)), gen


class _GlobalOnly:
    """In place of ``FlopCounterMode``'s module tracker: every count goes to
    "Global". The tracker's backward hooks break ``torch.autograd.grad``
    on a leaf, which the gradient penalty takes; counts by module are not
    needed here."""

    parents = frozenset({"Global"})

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def count(fn, device) -> dict:
    """One call of ``fn`` under ``FlopCounterMode``: the executed FLOPs in
    all and by operator, the block-conv operators' executed and model
    FLOPs and calls (``FLOP_LOG``), the model FLOPs of the program, and on
    the card the kernels' launches in the call."""
    block_conv.FLOP_LOG = []
    for f in block_conv.COUNTED:
        f.launches = 0
        if hasattr(f, "backward_launches"):
            f.backward_launches = 0
    try:
        mode = FlopCounterMode(display=False)
        mode.mod_tracker = _GlobalOnly()
        with mode:
            fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        log = block_conv.FLOP_LOG
    finally:
        block_conv.FLOP_LOG = None
    total = mode.get_total_flops()
    kernels = {}
    for name, executed, model in log:
        k = kernels.setdefault(name, {"calls": 0, "flops": 0, "model_flops": 0})
        k["calls"] += 1
        k["flops"] += executed
        k["model_flops"] += model
    out = dict(flops=total, model_flops=total + sum(k["model_flops"] - k["flops"] for k in kernels.values()),
               by_op={str(op): n for op, n in mode.get_flop_counts().get("Global", {}).items()},
               kernels=kernels)
    if device.type == "cuda":
        out["launches"] = {"block_conv3x3x3": block_conv.block_conv3x3x3.launches,
                           "block_conv3x3x3_backward": block_conv.block_conv3x3x3.backward_launches,
                           "s2d_conv3d_block": block_conv.s2d_conv3d_block.launches}
    return out


def programs(device, smoke: bool = False) -> dict:
    """Every program's count (``count``), keyed as the JAX script keys its
    programs, the direct-layout counterparts added; each with its
    ``jax_hlo_tflop`` (None for the direct ones)."""
    out = {}
    for layout, suffix in (("packed", ""), ("direct", "_direct")):
        state, steps, batch = setup_step(False, False, layout, device, smoke)
        out[f"combined_wc_128c_b12{suffix}"] = count(lambda: steps.combined_step(state, *batch), device)
        out[f"critic_only_128c_b12{suffix}"] = count(lambda: steps.critic_step(state, *batch), device)
        del state, steps, batch
        state, steps, batch = setup_step(True, False, layout, device, smoke)
        out[f"combined_gp_128c_b12{suffix}"] = count(lambda: steps.combined_step(state, *batch), device)
        del state, steps, batch
        if layout == "packed":
            state, steps, batch = setup_step(False, True, layout, device, smoke)
            out["combined_wc_128sq_b512"] = count(lambda: steps.combined_step(state, *batch), device)
            del state, steps, batch
        fwd, gen = setup_forward(layout, device, smoke)
        with torch.no_grad():
            out[f"inference_fwd_{layout}_128c_b24"] = count(fwd, device)
        del fwd, gen
        if device.type == "cuda":
            torch.cuda.empty_cache()
    for name, r in out.items():
        r["jax_hlo_tflop"] = JAX_HLO_TFLOP.get(name)
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--json", action="store_true", help="one JSON object")
    p.add_argument("--smoke", action="store_true", help="tiny shapes and models (the counts mean nothing)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the command in-process; returns the counts by program."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    out = programs(device, smoke=args.smoke)
    if args.json:
        print(json.dumps(out, indent=2))
    else:
        for name, r in out.items():
            jax = f"; JAX XLA {r['jax_hlo_tflop']:.3f} TFLOP" if r["jax_hlo_tflop"] is not None else ""
            kern = ", ".join(f"{k} {v['flops'] / 1e12:.4f} ({v['model_flops'] / 1e12:.4f} model) in {v['calls']}"
                             for k, v in r["kernels"].items())
            print(f"{name}: {r['flops'] / 1e12:.4f} TFLOP executed, {r['model_flops'] / 1e12:.4f} model{jax}"
                  + (f"; {kern}" if kern else ""))
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
