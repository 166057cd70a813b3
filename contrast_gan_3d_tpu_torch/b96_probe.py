"""Attribution of the saturated batch-96 train step (the port's counterpart
of the JAX package's ``scripts/b96_probe.py``):

    python -m contrast_gan_3d_tpu_torch.b96_probe                      # both modes, 48 + 48 at 128^3, on the card
    python -m contrast_gan_3d_tpu_torch.b96_probe --attrib --n-opt 6 --n-sub 6 --reps 1
    python -m contrast_gan_3d_tpu_torch.b96_probe --smoke --patch 16 16 16 --n-opt 2 --n-sub 2 --device cpu

The networks are the default-width generator (packed layout) and critic
in bf16, the step ``StepConfig(weight_clip=0.01, augment=None,
dtype=bf16)``, Adam, and the batches seeded int16 patches (``--n-opt``
OPT, ``--n-sub`` sub-optimal with a 0.1% mask), as in the JAX probe.

Modes (both by default):
- ``--attrib``: the 48 + 48 step split into four timed programs: the
  generator's eval-mode forward on the scaled sub-optimal batch
  (``gen_forward_only``), then ``critic_step`` (generator forward + critic
  update), ``generator_only_step`` (generator forward and backward, its
  update) and ``combined_step`` from ``build_train_steps``, each on a fresh
  state. One JSON line each: ``{"probe", "sec", "batch", "patch"}``.
- ``--stages``: the generator's backward by stage. The loss is
  ``sum(out.float() ** 2)`` of the output of stage K (``first``,
  ``down_<i>``, ``resnet_<i>``, ``up_<i>`` wide to narrow,
  ``last_conv``), its gradient taken over the generator's parameters in
  train mode. JAX reads stage K's output through ``capture_intermediates``
  and lets XLA drop the later stages; PyTorch drops no dead code, so
  ``ResnetGenerator.packed_prefix`` runs the generator's own packed stage
  loop only up to stage K. The sum of squares does not depend on the
  layout a stage leaves its output in, so the losses are JAX's. One line
  per stage: ``{"probe": "prefix_through_<stage>", "sec",
  "delta_vs_prev"}``; consecutive deltas are each stage's forward and
  backward.

Each time is the least of ``--reps`` calls after one warm call, each call
completed by reading one scalar of its result on the host (``.item()``),
as the JAX probe fetches one. JAX's ``--xla-option`` (XLA compiler options
for an AOT-compiled step) has no counterpart: the port compiles no
program; its kernels are cuDNN's and cuBLAS's, chosen at run time.
``--smoke`` shrinks the networks (the times then mean nothing). stdout
carries the JSON lines only; logs go to stderr.
"""

import argparse
import json
import sys
import time
from functools import partial

import numpy as np
import torch

from contrast_gan_3d_tpu_torch.models.discriminator import PatchGANDiscriminator
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.trainer.optim import make_optimizer
from contrast_gan_3d_tpu_torch.trainer.steps import StepConfig, build_train_steps, init_state
from contrast_gan_3d_tpu_torch.utils.device import resolve_device
from contrast_gan_3d_tpu_torch.utils.logging_utils import create_logger, project_logs_to_stderr

LOGGER = "contrast_gan_3d_tpu_torch.b96_probe"
ATTRIB_PROBES = ("gen_forward_only", "critic_step", "generator_only_step", "combined_step")
SMOKE_GEN = {"n_resnet_blocks": 1, "init_channels_out": 4}
SMOKE_CRITIC = {"init_channels_out": 4, "discriminator_depth": 2}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--attrib", action="store_true", help="time the four programs")
    p.add_argument("--stages", action="store_true", help="time the generator's prefix gradients by stage")
    p.add_argument("--n-opt", type=int, default=48)
    p.add_argument("--n-sub", type=int, default=48)
    p.add_argument("--patch", type=int, nargs=3, default=(128, 128, 128))
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--smoke", action="store_true", help="tiny networks (the times then mean nothing)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def timed(fn, reps: int = 3) -> float:
    """The least of ``reps`` calls of ``fn`` after one warm call, seconds;
    ``fn`` completes its work before it returns (a scalar read)."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def fresh_state(seed: int, device, smoke: bool = False):
    """A train state of the probe's bf16 generator (packed layout) and
    critic, initialised from ``seed``, with Adam."""
    torch.manual_seed(seed)
    gen = ResnetGenerator(**(SMOKE_GEN if smoke else {}), layout="packed", dtype=torch.bfloat16)
    critic = PatchGANDiscriminator(**(SMOKE_CRITIC if smoke else {}), dtype=torch.bfloat16)
    tx = partial(make_optimizer, "adam")
    return init_state(gen, critic, tx, tx, device=device)


def batches(n_opt: int, n_sub: int, patch, device):
    """The JAX probe's seeded int16 batches (OPT, sub-optimal, mask), on
    ``device``."""
    rng = np.random.default_rng(0)
    opt = rng.integers(-1024, 1500, (n_opt, *patch), np.int16)
    sub = rng.integers(-1024, 1500, (n_sub, *patch), np.int16)
    msk = (rng.random((n_sub, *patch)) < 0.001).astype(np.int16)
    return tuple(torch.from_numpy(a).to(device) for a in (opt, sub, msk))


def scaled(cfg: StepConfig, sub: torch.Tensor) -> torch.Tensor:
    """The sub-optimal batch as the generator takes it: scaled in f32,
    cast to ``cfg.dtype``, NCDHW."""
    return cfg.scaler(sub.float()).to(cfg.dtype).unsqueeze(1)


def prefix_grads(gen: ResnetGenerator, x: torch.Tensor, stage: str) -> dict:
    """The JAX probe's loss, ``sum(out.float() ** 2)`` of ``stage``'s
    output with the packed layout run up to ``stage``, under ``"loss"``,
    and its gradient over the generator's parameters by name (None for
    the parameters of the stages after ``stage``)."""
    names, params = zip(*gen.named_parameters())
    loss = gen.packed_prefix(x, stage).float().pow(2).sum()
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return {"loss": loss.detach(), **dict(zip(names, grads))}


def attrib(state, steps, cfg: StepConfig, batch, reps: int, fresh):
    """Yield ``(program, seconds)`` for the four programs (``fresh()``: a
    new state for each train step program)."""
    gen = state.generator
    x = scaled(cfg, batch[1])
    gen.eval()
    try:
        with torch.no_grad():
            sec = timed(lambda: gen(x)[0, 0, 0, 0, 0].item(), reps)
    finally:
        gen.train()
    del x
    yield "gen_forward_only", sec
    for name in ATTRIB_PROBES[1:]:
        branch, s = getattr(steps, name), fresh()

        def run():
            _, metrics = branch(s, *batch)
            next(iter(metrics.values())).item()

        yield name, timed(run, reps)


def stages(state, cfg: StepConfig, batch, reps: int):
    """Yield ``(stage, seconds)`` of the prefix gradients, in stage
    order."""
    gen = state.generator
    x = scaled(cfg, batch[1])
    for stage in gen.stage_names():
        def run():
            prefix_grads(gen, x, stage)["first.conv.weight"].reshape(-1)[0].item()

        yield stage, timed(run, reps)


def main(argv=None) -> list:
    """Run the command in-process; prints the JSON lines and returns them
    as dicts."""
    args = parse_args(argv)
    project_logs_to_stderr()
    logger = create_logger(LOGGER)
    device = resolve_device(args.device)
    do_attrib = args.attrib or not args.stages
    do_stages = args.stages or not args.attrib
    patch = tuple(args.patch)
    cfg = StepConfig(weight_clip=0.01, augment=None, dtype=torch.bfloat16)
    state = fresh_state(0, device, args.smoke)
    steps = build_train_steps(cfg)
    batch = batches(args.n_opt, args.n_sub, patch, device)
    logger.info("b96 probe on %s: %d + %d patches of %s, bf16 packed%s", device, args.n_opt, args.n_sub, patch,
                " (smoke widths)" if args.smoke else "")
    lines = []

    def emit(record):
        lines.append(record)
        print(json.dumps(record), flush=True)

    if do_attrib:
        for name, sec in attrib(state, steps, cfg, batch, args.reps,
                                lambda: fresh_state(1, device, args.smoke)):
            emit({"probe": name, "sec": round(sec, 4), "batch": [args.n_opt, args.n_sub], "patch": list(patch)})
    if do_stages:
        prev = 0.0
        for stage, sec in stages(state, cfg, batch, args.reps):
            emit({"probe": f"prefix_through_{stage}", "sec": round(sec, 4), "delta_vs_prev": round(sec - prev, 4)})
            prev = sec
    return lines


if __name__ == "__main__":
    main()
    sys.exit(0)
