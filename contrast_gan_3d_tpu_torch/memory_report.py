"""Device-memory report of the port's main programs (the counterpart of the
JAX package's ``scripts/memory_report.py``):

    python -m contrast_gan_3d_tpu_torch.memory_report --out memreport/
    python -m contrast_gan_3d_tpu_torch.memory_report --out memreport/ --programs cycle5,gp96_sp2
    python -m contrast_gan_3d_tpu_torch.memory_report --out memreport/ --tiny --device cpu

The programs are JAX's seven, by JAX's names (``--programs``, a comma
list; the default is all seven), at the JAX report's settings (bf16, the
packed layout, no augmentation in the step: the host warps), with seeded
random weights:
- ``corrector``: the packed corrector on a 512x512x400 volume at 25%
  overlap, batch 24;
- ``train`` / ``train_gp``: ``combined_step`` at 6 + 3 + 3 128^3 patches,
  weight clip (WC) and gradient penalty (GP);
- ``train96``: the WC ``combined_step`` at 48 + 48 (24 + 24 sub-optimal);
- ``cycle5``: the WC 5-iteration cycle at 6 + 6 (a combined step, four
  critic steps), the production default: its first call runs eagerly,
  the measured one captures the CUDA graph and replays it, so its peak is
  the replayed graph's pool at its peak;
- ``gp96_sp2`` / ``gp96_dp2``: the GP ``combined_step`` at 48 + 48 over a
  (1, 2) dp x sp mesh (each rank an X-slab of every patch) and a (2, 1) dp
  mesh (each rank 24 + 24 whole patches): two gloo ranks on this device
  (``parallel/mesh.spawn_ranks``), each its own process, so each peak is
  that rank's own. A pair that the device cannot hold together is
  reported as not held, with the first line of the error.
``gp96`` (not in JAX's list) is the same GP step on one rank, the mesh
programs' reference.

For each: the analytic bytes of its arguments (inputs, parameters,
optimizer state) and outputs, the measured peak of one warm call and its
seconds (``utils/memory.program_memory_summary``), and the allocator's live
blocks after it. A program the card cannot hold says so (every program
runs without rematerialisation, the builder's default on this card). Writes
``memory_report.md`` and ``memory_report.json`` into ``--out`` and prints
the markdown. ``--tiny``: 16^3 patches, narrow networks and a 40x36x32
volume, for a drive on the CPU (whose peaks are "not measured"). JAX's
``--skip-run`` has no counterpart: the port compiles nothing, so every
figure comes from a run.
"""

import argparse
import datetime
import json
import sys
import tempfile
from functools import partial
from pathlib import Path

import numpy as np
import torch
from torch.multiprocessing.spawn import ProcessException

from contrast_gan_3d_tpu_torch.eval.corrector import CCTAContrastCorrector
from contrast_gan_3d_tpu_torch.models.discriminator import PatchGANDiscriminator
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.parallel.mesh import LOCAL, dp_sp_mesh, spawn_ranks
from contrast_gan_3d_tpu_torch.trainer.optim import make_optimizer
from contrast_gan_3d_tpu_torch.trainer.steps import (
    StepConfig,
    build_cycle_step,
    build_train_steps,
    init_state,
    schedule_branches,
)
from contrast_gan_3d_tpu_torch.utils.device import resolve_device
from contrast_gan_3d_tpu_torch.utils.memory import format_bytes, live_buffer_table, program_memory_summary

PROGRAMS = ("corrector", "train", "train_gp", "train96", "cycle5", "gp96_sp2", "gp96_dp2")
EXTRA_PROGRAMS = ("gp96",)
# (data, space) of each mesh program
MESHES = {"gp96_sp2": (1, 2), "gp96_dp2": (2, 1)}
MESH_TIMEOUT_S = 600  # what a rank waits in one collective before it fails
FULL = dict(patch=(128, 128, 128), volume=(512, 512, 400), corrector_batch=24, mixes=((6, 6), (48, 48)),
            gen={}, critic={})
# 16^3 splits over two spatial ranks in slabs of 8 rows, whole blocks of the packed layout
TINY = dict(patch=(16, 16, 16), volume=(40, 36, 32), corrector_batch=2, mixes=((2, 2), (4, 4)),
            gen=dict(n_resnet_blocks=1, n_updownsample_blocks=1, init_channels_out=4),
            critic=dict(init_channels_out=4, discriminator_depth=2))
CYCLE = schedule_branches(1, 5, 0, 5)  # a combined step, then four critic steps


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


def _train_setup(size: dict, gp: bool, device, mesh=LOCAL):
    """The bf16 packed networks, state and steps every train program
    shares (the JAX report's ``_wgan_setup``)."""
    torch.manual_seed(0)
    gen = ResnetGenerator(dtype=torch.bfloat16, layout="packed", **size["gen"])
    critic = PatchGANDiscriminator(dtype=torch.bfloat16, norm=None if gp else "batch", **size["critic"])
    tx = partial(make_optimizer, "adam", lr=1e-4, betas=(0.0, 0.9) if gp else (0.5, 0.999))
    state = init_state(gen, critic, tx, tx, seed=0, device=device, mesh=mesh)
    steps = build_train_steps(StepConfig(weight_clip=None if gp else 0.01, dtype=torch.bfloat16, augment=None))
    return state, steps


def _batches(size: dict, lead: tuple, n_opt: int, n_sub: int, device):
    """Seeded int16 (opt, sub-optimal, mask) batches of ``lead + (n, *patch)``."""
    rng = np.random.default_rng(0)
    opt, sub = (_int16(rng, (*lead, n, *size["patch"]), device) for n in (n_opt, n_sub))
    msk = torch.as_tensor((rng.random((*lead, n_sub, *size["patch"])) < 0.001).astype(np.int16), device=device)
    return opt, sub, msk


def train_program(size: dict, n_opt: int, n_sub: int, gp: bool, device, mesh=LOCAL):
    """(fn, arguments) of one bf16 packed ``combined_step``; under ``mesh``
    this rank's share of the batch (its data index's whole patches: the
    step keeps its slab)."""
    state, steps = _train_setup(size, gp, device, mesh)
    opt, sub, msk = _batches(size, (), n_opt, n_sub, device)
    opt = opt[mesh.global_slice(n_opt // mesh.data_size)].clone()
    sub, msk = (t[mesh.global_slice(n_sub // mesh.data_size)].clone() for t in (sub, msk))
    arguments = (state.generator, state.critic, state.gen_opt.optimizer, state.critic_opt.optimizer, opt, sub, msk)
    return (lambda: steps.combined_step(state, opt, sub, msk)[1]), arguments


def cycle_program(size: dict, n_opt: int, n_sub: int, device):
    """(fn, arguments) of the WC 5-iteration cycle: on the card its first
    call runs eagerly and the second captures the graph and replays it."""
    state, steps = _train_setup(size, False, device)
    cycle = build_cycle_step(steps, CYCLE)
    opt, sub, msk = _batches(size, (len(CYCLE),), n_opt, n_sub, device)
    arguments = (state.generator, state.critic, state.gen_opt.optimizer, state.critic_opt.optimizer, opt, sub, msk)
    return (lambda: cycle(state, opt, sub, msk)[1]), arguments


def programs(size: dict) -> dict:
    """name -> (title, builder of (fn, arguments), mesh or None) of each
    program the report covers."""
    (n_opt, n_sub), (big_opt, big_sub) = size["mixes"]
    mix = f"{n_opt}+{n_sub // 2}+{n_sub // 2}"
    gp_big = partial(train_program, size, big_opt, big_sub, True)
    out = {
        "corrector": (f"packed corrector bf16 {'x'.join(map(str, size['volume']))} at 25%, batch "
                      f"{size['corrector_batch']}", partial(corrector_program, size)),
        "train": (f"combined_step WC bf16 packed {mix}", partial(train_program, size, n_opt, n_sub, False)),
        "train_gp": (f"combined_step GP bf16 packed {mix}", partial(train_program, size, n_opt, n_sub, True)),
        "train96": (f"combined_step WC bf16 packed {big_opt}+{big_sub}",
                    partial(train_program, size, big_opt, big_sub, False)),
        "cycle5": (f"5-iteration WC cycle bf16 packed {n_opt}+{n_sub} (a replayed CUDA graph on the card)",
                   partial(cycle_program, size, n_opt, n_sub)),
        "gp96": (f"combined_step GP bf16 packed {big_opt}+{big_sub}, one rank", gp_big),
    }
    for name, (d, s) in MESHES.items():
        out[name] = (f"combined_step GP bf16 packed {big_opt}+{big_sub} over a ({d}, {s}) "
                     f"{'dp x sp' if s > 1 else 'dp'} mesh, two gloo ranks on one device, per rank", gp_big)
    return {k: (title, build, MESHES.get(k)) for k, (title, build) in out.items()}


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


def _mesh_rank(program: str, tiny: bool, device: str, out_dir: str):
    """One rank of a mesh program: its row (its own peak and seconds), or
    the first line of what stopped it (an OOM here, or the collective its
    peer left), into ``out_dir``."""
    size = TINY if tiny else FULL
    d, s = MESHES[program]
    if device == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    mesh = dp_sp_mesh(d, s, device=device)
    title, build, _ = programs(size)[program]
    try:
        row = measure(title, partial(build, mesh=mesh), mesh.device)
    except RuntimeError as e:  # the peer stopped mid-step: its own row says why
        row = dict(name=title, fits=False, error=str(e).splitlines()[0])
    row.pop("live", None)
    torch.save(dict(row, rank=mesh.rank), Path(out_dir) / f"rank{mesh.rank}.pt")


def measure_mesh(program: str, tiny: bool, device) -> dict:
    """A mesh program's row: both ranks' rows, held where both fit; else
    the first OOM's line (or the first error's)."""
    if device.type == "cuda":
        torch.cuda.empty_cache()
    title = programs(TINY if tiny else FULL)[program][0]
    d, s = MESHES[program]
    # both ranks on this one device
    rank_device = f"cuda:{torch.cuda.current_device() if device.index is None else device.index}" \
        if device.type == "cuda" else "cpu"
    with tempfile.TemporaryDirectory(prefix="memory_report_") as tmp:
        try:
            spawn_ranks(_mesh_rank, d * s, (program, tiny, rank_device, tmp), backend="gloo",
                        timeout=MESH_TIMEOUT_S)
        except ProcessException as e:  # a rank died without writing its row
            return dict(name=title, fits=False, mesh=[d, s], error=str(e).strip().splitlines()[-1])
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(d * s)]
    row = dict(name=title, fits=all(r["fits"] for r in ranks), mesh=[d, s], ranks=ranks)
    if not row["fits"]:
        errors = [r["error"] for r in ranks if not r["fits"]]
        row["error"] = next((e for e in errors if "out of memory" in e.lower()), errors[0])
    return row


def _cell(values, fmt) -> str:
    return " / ".join(fmt(v) for v in values)


def markdown(rows, device, card: str) -> str:
    lines = [f"# Device memory of the port's programs ({card}; {datetime.date.today()})", "",
             "| program | arguments | outputs | peak of a warm call | allocated before it | the call's own | "
             "seconds | note |", "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        label = f"`{r['program']}`: {r['name']}"
        if not r["fits"]:
            what = "the two ranks together" if "mesh" in r else "the card"
            lines.append(f"| {label} | | | | | | | not held by {what} without rematerialisation (not ported): "
                         f"{r['error']} |")
            continue
        parts = r.get("ranks", [r])  # a mesh program: each rank's figures, rank 0 first
        measured = parts[0]["peak_bytes"] is not None
        own = [p["peak_bytes"] - p["baseline_bytes"] if measured else None for p in parts]
        note = "fits without rematerialisation" if measured else ""
        if "ranks" in r:
            note = f"per rank, rank 0 / rank 1; {note}" if note else "per rank, rank 0 / rank 1"
        lines.append(f"| {label} | {_cell([p['argument_bytes'] for p in parts], format_bytes)} | "
                     f"{_cell([p['output_bytes'] for p in parts], format_bytes)} | "
                     f"{_cell([p['peak_bytes'] for p in parts], format_bytes)} | "
                     f"{_cell([p['baseline_bytes'] for p in parts], format_bytes)} | {_cell(own, format_bytes)} | "
                     f"{_cell([p['seconds'] for p in parts], lambda v: f'{v:.4f}')} | {note} |")
    lines += ["", f"Peaks: `torch.cuda.max_memory_allocated` over the second of two calls on {device} (not "
                  f"measured on the CPU), in each rank's own process for a mesh program; the call's own is the "
                  f"peak less what was allocated before it (its arguments, and what the process held already). "
                  f"`cycle5`'s second call captures the CUDA graph and replays it: its peak is the graph's pool."]
    return "\n".join(lines)


def _program_list(text: str) -> list:
    names = [n.strip() for n in text.split(",") if n.strip()]
    unknown = [n for n in names if n not in PROGRAMS + EXTRA_PROGRAMS]
    if unknown or not names:
        raise argparse.ArgumentTypeError(f"unknown program(s) {unknown or text!r}: choose from "
                                         f"{','.join(PROGRAMS + EXTRA_PROGRAMS)}")
    return names


def main(argv=None) -> list:
    """Run the report; returns its rows."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True, type=Path, help="directory for memory_report.md / .json")
    p.add_argument("--programs", type=_program_list, default=list(PROGRAMS),
                   help=f"comma list from {','.join(PROGRAMS + EXTRA_PROGRAMS)} (default: JAX's seven, "
                        f"{','.join(PROGRAMS)}); the gp96_* programs run two gloo ranks on the one device. There "
                        f"is no --skip-run: the port compiles nothing ahead of a run")
    p.add_argument("--tiny", action="store_true", help="16^3 patches and narrow networks (a CPU drive)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    table = programs(TINY if args.tiny else FULL)
    rows = []
    for name in args.programs:
        title, build, mesh = table[name]
        row = measure_mesh(name, args.tiny, device) if mesh else measure(title, build, device)
        rows.append(dict(program=name, **row))
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
