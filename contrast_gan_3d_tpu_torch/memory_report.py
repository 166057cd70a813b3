"""Device-memory report of the port's main programs (the counterpart of the
JAX package's ``scripts/memory_report.py``):

    python -m contrast_gan_3d_tpu_torch.memory_report --out memreport/
    python -m contrast_gan_3d_tpu_torch.memory_report --out memreport/ --tiny --device cpu

The programs are JAX's set, at the JAX report's settings (bf16, the packed
layout, no augmentation in the step: the host warps), with seeded random
weights:
- the packed corrector on a 512x512x400 volume at 25% overlap, batch 24;
- ``combined_step`` at 6 + 3 + 3 128^3 patches, weight clip (WC) and
  gradient penalty (GP);
- the WC ``combined_step`` at 48 + 48 (24 + 24 sub-optimal).

For each: the analytic bytes of its arguments (inputs, parameters,
optimizer state) and outputs, the measured peak of one warm call and its
seconds (``utils/memory.program_memory_summary``), and the allocator's live
blocks after it. A program the card cannot hold says so (every program
runs without rematerialisation, the builder's default on this card). Writes
``memory_report.md`` and ``memory_report.json`` into ``--out`` and prints
the markdown. ``--tiny``: 16^3 patches, narrow networks and a 40x36x32
volume, for a drive on the CPU (whose peaks are "not measured").
"""

import argparse
import datetime
import json
import sys
from functools import partial
from pathlib import Path

import numpy as np
import torch

from contrast_gan_3d_tpu_torch.eval.corrector import CCTAContrastCorrector
from contrast_gan_3d_tpu_torch.models.discriminator import PatchGANDiscriminator
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.trainer.optim import make_optimizer
from contrast_gan_3d_tpu_torch.trainer.steps import StepConfig, build_train_steps, init_state
from contrast_gan_3d_tpu_torch.utils.device import resolve_device
from contrast_gan_3d_tpu_torch.utils.memory import format_bytes, live_buffer_table, program_memory_summary

FULL = dict(patch=(128, 128, 128), volume=(512, 512, 400), corrector_batch=24, mixes=((6, 6), (48, 48)),
            gen={}, critic={})
TINY = dict(patch=(16, 16, 16), volume=(40, 36, 32), corrector_batch=2, mixes=((2, 2), (4, 4)),
            gen=dict(n_resnet_blocks=1, n_updownsample_blocks=1, init_channels_out=4),
            critic=dict(init_channels_out=4, discriminator_depth=2))


def _int16(rng, shape, device):
    return torch.as_tensor(rng.integers(-1024, 1500, shape).astype(np.int16), device=device)


def corrector_program(size: dict, device):
    """(fn, arguments) of the packed bf16 corrector on one volume."""
    torch.manual_seed(0)
    gen = ResnetGenerator(dtype=torch.bfloat16, **size["gen"])
    corrector = CCTAContrastCorrector(gen, inference_patch_size=size["patch"], overlap=0.25,
                                      batch_size=size["corrector_batch"], dtype=torch.bfloat16, device=device)
    if not corrector.packed:
        raise AssertionError("the corrector's default layout should be packed here")
    vol = _int16(np.random.default_rng(0), size["volume"], device)
    return (lambda: corrector(vol)), (corrector.generator, vol)


def train_program(size: dict, n_opt: int, n_sub: int, gp: bool, device):
    """(fn, arguments) of one bf16 packed ``combined_step``."""
    torch.manual_seed(0)
    gen = ResnetGenerator(dtype=torch.bfloat16, layout="packed", **size["gen"])
    critic = PatchGANDiscriminator(dtype=torch.bfloat16, norm=None if gp else "batch", **size["critic"])
    tx = partial(make_optimizer, "adam", lr=1e-4, betas=(0.0, 0.9) if gp else (0.5, 0.999))
    state = init_state(gen, critic, tx, tx, seed=0, device=device)
    steps = build_train_steps(StepConfig(weight_clip=None if gp else 0.01, dtype=torch.bfloat16, augment=None))
    rng = np.random.default_rng(0)
    opt, sub = _int16(rng, (n_opt, *size["patch"]), device), _int16(rng, (n_sub, *size["patch"]), device)
    msk = torch.as_tensor((rng.random((n_sub, *size["patch"])) < 0.001).astype(np.int16), device=device)
    arguments = (state.generator, state.critic, state.gen_opt.optimizer, state.critic_opt.optimizer, opt, sub, msk)
    return (lambda: steps.combined_step(state, opt, sub, msk)[1]), arguments


def programs(size: dict):
    """(name, builder) of each program the report covers."""
    (n_opt, n_sub), (big_opt, big_sub) = size["mixes"]
    mix = f"{n_opt}+{n_sub // 2}+{n_sub // 2}"
    return [
        (f"packed corrector bf16 {'x'.join(map(str, size['volume']))} at 25%, batch {size['corrector_batch']}",
         partial(corrector_program, size)),
        (f"combined_step WC bf16 packed {mix}", partial(train_program, size, n_opt, n_sub, False)),
        (f"combined_step GP bf16 packed {mix}", partial(train_program, size, n_opt, n_sub, True)),
        (f"combined_step WC bf16 packed {big_opt}+{big_sub}", partial(train_program, size, big_opt, big_sub, False)),
    ]


def measure(name: str, build, device) -> dict:
    """One program's row; a program the card cannot hold is recorded as such."""
    try:
        fn, arguments = build(device)
        row = dict(name=name, fits=True, **program_memory_summary(fn, arguments, device))
        row["live"] = live_buffer_table(top=10, device=device)
        del fn, arguments
    except torch.cuda.OutOfMemoryError as e:
        row = dict(name=name, fits=False, error=str(e).splitlines()[0])
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return row


def markdown(rows, device, card: str) -> str:
    lines = [f"# Device memory of the port's programs ({card}; {datetime.date.today()})", "",
             "| program | arguments | outputs | peak of a warm call | allocated before it | the call's own | "
             "seconds | note |", "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if not r["fits"]:
            lines.append(f"| {r['name']} | | | | | | | does not fit on the card without rematerialisation "
                         f"(not ported): {r['error']} |")
            continue
        measured = r["peak_bytes"] is not None
        own = r["peak_bytes"] - r["baseline_bytes"] if measured else None
        lines.append(f"| {r['name']} | {format_bytes(r['argument_bytes'])} | {format_bytes(r['output_bytes'])} | "
                     f"{format_bytes(r['peak_bytes'])} | {format_bytes(r['baseline_bytes'])} | {format_bytes(own)} | "
                     f"{r['seconds']:.4f} | {'fits without rematerialisation' if measured else ''} |")
    lines += ["", f"Peaks: `torch.cuda.max_memory_allocated` over the second of two calls on {device} (not "
                  f"measured on the CPU); the call's own is the peak less what was allocated before it (its "
                  f"arguments, and what the process held already)."]
    return "\n".join(lines)


def main(argv=None) -> list:
    """Run the report; returns its rows."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True, type=Path, help="directory for memory_report.md / .json")
    p.add_argument("--tiny", action="store_true", help="16^3 patches and narrow networks (a CPU drive)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    rows = [measure(name, build, device) for name, build in programs(TINY if args.tiny else FULL)]
    args.out.mkdir(parents=True, exist_ok=True)
    report = markdown(rows, device, card)
    (args.out / "memory_report.md").write_text(report + "\n")
    (args.out / "memory_report.json").write_text(json.dumps(dict(card=card, device=str(device), rows=rows),
                                                            indent=1, default=str))
    print(report)
    return rows


if __name__ == "__main__":
    main()
    sys.exit(0)
