"""Quality evidence for the sliding window's overlap (the port's counterpart
of the JAX package's ``scripts/eval_overlap_quality.py``):

    python -m contrast_gan_3d_tpu_torch.eval_overlap_quality --iterations 400 \\
        --out overlap.json

Serving corrects at 25% overlap; 50% is the nnU-Net-style gold standard
and 0 the reference's uniform tiles. This command trains basic_3d at lr
1e-3 for ``--iterations`` on nine synthetic ``--train-shape`` patients
(the JAX script's cohort and draws) through the port's ``build``, loaders
and ``Trainer``, or with ``--iterations 0`` keeps the freshly initialised
generator (a rougher field than any trained one), then corrects a held-out
``--eval-shape`` LOW scan in bf16 at overlap 0, 0.25 and 0.5 through the
port's corrector (128^3 patches, batch ``--batch``) and reports the JAX
script's JSON: centerline and background mean HU per overlap, the
voxelwise |delta| between 25% and 50% and between 0 and 25%, and each
correction's latency (the best of 3 warm calls, the volume already on the
device), with the card's name and power limit beside them (``card``).
Runs on the card unless ``--device cpu``.
"""

import argparse
import json
import logging
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from contrast_gan_3d_tpu_torch import validate_learning
from contrast_gan_3d_tpu_torch.data.pipeline import create_loaders
from contrast_gan_3d_tpu_torch.data.preprocess import write_patient
from contrast_gan_3d_tpu_torch.eval.corrector import CCTAContrastCorrector
from contrast_gan_3d_tpu_torch.experiments.builder import build
from contrast_gan_3d_tpu_torch.experiments.config import load_config
from contrast_gan_3d_tpu_torch.trainer import checkpoint as ckpt_lib
from contrast_gan_3d_tpu_torch.trainer.trainer import Trainer
from contrast_gan_3d_tpu_torch.utils.device import full_f32, resolve_device

logger = logging.getLogger("contrast_gan_3d_tpu_torch.eval_overlap_quality")

EVAL_PATCH = (128, 128, 128)
OVERLAPS = (0.0, 0.25, 0.5)
TIMED_REPS = 3


def synth_patient(rng, shape, vessel_hu, n_points=None):
    """The JAX script's held-out and training scans: ``validate_learning``'s
    synthetic scan with ``max(60, 2 * X)`` centerline points by default."""
    return validate_learning.synth_patient(rng, shape, vessel_hu, n_points or max(60, 2 * shape[0]))


def overlap_metrics(corrected_by_overlap: dict, mask: np.ndarray) -> dict:
    """The JAX script's pairwise deltas: 25% against 50% and 0 against 25%,
    voxelwise (mean, p99, max, on the centerline) and of the centerline
    means."""
    out = {}
    for a, b in ((0.25, 0.5), (0.0, 0.25)):
        tag = f"{int(a * 100)}_vs_{int(b * 100)}"
        d = np.abs(corrected_by_overlap[a] - corrected_by_overlap[b])
        out[f"abs_delta_{tag}_hu"] = {
            "mean": round(float(d.mean()), 3),
            "p99": round(float(np.percentile(d, 99)), 3),
            "max": round(float(d.max()), 3),
            "centerline_mean": round(float(d[mask].mean()), 3),
            "centerline_max": round(float(d[mask].max()), 3),
        }
        ctl_a = float(corrected_by_overlap[a][mask].mean())
        ctl_b = float(corrected_by_overlap[b][mask].mean())
        out[f"centerline_delta_{tag}_hu"] = round(abs(ctl_a - ctl_b), 3)
    return out


def card_info(device: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card (the device name
    where nvidia-smi cannot be asked; "cpu" on the CPU)."""
    if device.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(device)


def timed(correct, vol: torch.Tensor, reps: int = TIMED_REPS):
    """(host f32 correction, best seconds of ``reps`` warm calls); the
    volume is already on the device, each call waits for the device."""
    sync = torch.cuda.synchronize if vol.is_cuda else (lambda: None)
    out = correct(vol)
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = correct(vol)
        sync()
        times.append(time.perf_counter() - t0)
    return out.float().cpu().numpy(), min(times)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--iterations", type=int, default=400)
    p.add_argument("--train-shape", type=int, nargs=3, default=(192, 192, 160))
    p.add_argument("--eval-shape", type=int, nargs=3, default=(512, 512, 400))
    p.add_argument("--batch", type=int, default=8, help="inference batch")
    p.add_argument("--out", type=Path, default=None, help="also write the JSON here")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the study in-process; returns the JSON results."""
    args = parse_args(argv)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(name)s | %(levelname)s | %(message)s")
    device = resolve_device(args.device)
    tmp = Path(tempfile.mkdtemp(prefix="cgan3d_overlap_"))
    rng = np.random.default_rng(0)
    cfg = replace(
        load_config("basic_3d"),
        train_iterations=args.iterations,
        validate_every=None,
        checkpoint_every=max(1, args.iterations),
        log_every=max(1, args.iterations // 8),
        log_images_every=None,
        lr=1e-3,  # weight clipping converges fast at 1e-3 (validate_learning)
        milestones=(),
        num_workers=(2, 1),
        logger="console",
    )
    built = build(cfg, checkpoint_dir=str(tmp / "ckpt"), device=str(device))
    trainer = Trainer(built.generator, built.critic, built.gen_tx, built.critic_tx, built.step_config,
                      built.trainer_config, seed=built.seed, logger_interface=built.logger_interface,
                      device=str(device))
    train_s = 0.0
    if args.iterations > 0:
        fold = []
        for label, hu in {0: 400, -1: 250, 1: 550}.items():
            for i in range(3):
                vol, mask, meta = synth_patient(rng, tuple(args.train_shape), hu)
                fold.append((str(write_patient(vol, mask, meta, f"s{label}_{i}", tmp / "data")), label))
        loaders = create_loaders(fold, cfg.train_patch_size, cfg.train_batch_size, np.random.default_rng(built.seed),
                                 num_threads=2, augmenter=built.host_augmenter, device=str(device))
        t0 = time.perf_counter()
        with full_f32():
            trainer.fit(loaders)
        train_s = time.perf_counter() - t0
    else:
        # the freshly initialised generator: its tanh field is far rougher
        # than a trained one's, so overlap invariance here bounds the
        # trained case
        ckpt_lib.save_checkpoint(trainer.state, tmp / "ckpt", step=0, meta=trainer._ckpt_meta)

    vol, mask, _ = synth_patient(rng, tuple(args.eval_shape), 250)
    m = mask.astype(bool)
    results = {
        "train_seconds": round(train_s, 1),
        "iterations": args.iterations,
        "eval_shape": list(args.eval_shape),
        "centerline_mean_hu_before": round(float(vol[m].mean()), 1),
        "background_mean_hu_before": round(float(vol[~m].mean()), 1),
        "target_corridor": [350, 450],
        "overlaps": {},
        "card": card_info(device),
    }
    vol_dev = torch.from_numpy(vol).to(device)
    corrected_by_overlap = {}
    for overlap in OVERLAPS:
        corrector = CCTAContrastCorrector.from_checkpoint(
            tmp / "ckpt", generator=built.generator, inference_patch_size=EVAL_PATCH, batch_size=args.batch,
            overlap=overlap, dtype=torch.bfloat16, device=device)
        corrected, sec = timed(corrector, vol_dev)
        corrected_by_overlap[overlap] = corrected
        results["overlaps"][str(overlap)] = {
            "centerline_mean_hu_after": round(float(corrected[m].mean()), 2),
            "background_mean_hu_after": round(float(corrected[~m].mean()), 2),
            "latency_s": round(sec, 3),
            "layout": "packed" if corrector.packed else "direct",
        }
        print(f"overlap {overlap}: {results['overlaps'][str(overlap)]}", flush=True)
    results.update(overlap_metrics(corrected_by_overlap, m))
    print(json.dumps(results))
    if args.out:
        args.out.write_text(json.dumps(results, indent=2) + "\n")
    return results


if __name__ == "__main__":
    main()
    sys.exit(0)
