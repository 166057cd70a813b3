"""Show that the port learns the contrast correction, on synthetic data (the
port's counterpart of the JAX package's ``scripts/validate_learning.py``):

    python -m contrast_gan_3d_tpu_torch.validate_learning --iterations 800 \\
        --cycle-length 5 --seed 3 --workdir study --eval-cohort 4

Builds the JAX script's synthetic cohort (rng seed 0: LOW scans carry
under-enhanced ~250 HU vessels, OPT ones ~400 HU, HIGH ones ~550 HU),
trains a small WGAN through the port's real pipeline (``build``, the
host-augmented loaders, ``Trainer.fit`` with fused cycles and
checkpointing) on the card unless ``--device cpu``, then corrects a
held-out LOW and a held-out HIGH scan with the trained generator
(``CCTAContrastCorrector.from_checkpoint``) and measures their centerline
HU: the correction must move both toward the 350-450 HU corridor. Prints
the JAX script's JSON summary. Each label's loader has one worker thread,
so that a run repeats on one device (under cuDNN's deterministic
algorithms on the card); the JAX script's two race for the sampler.
``--eval-cohort N`` also writes N held-out raw LOW scans and OPT anchors
in the raw layout ``preprocess`` reads, the corrected LOW files, and
``original_list.json`` / ``corrected_list.json`` for ``eval_hu_shift``.
``--data-format h5`` writes the cohort into one HDF5 corpus file and trains
from its members (h5py, absent on the card's machine).
"""

import argparse
import json
import logging
import sys
import tempfile
from dataclasses import replace
from pathlib import Path

import numpy as np

from contrast_gan_3d_tpu_torch.data.pipeline import create_loaders
from contrast_gan_3d_tpu_torch.data.preprocess import write_patient
from contrast_gan_3d_tpu_torch.eval.corrector import CCTAContrastCorrector
from contrast_gan_3d_tpu_torch.experiments.builder import build
from contrast_gan_3d_tpu_torch.experiments.config import load_config
from contrast_gan_3d_tpu_torch.trainer.trainer import Trainer
from contrast_gan_3d_tpu_torch.utils import io_utils
from contrast_gan_3d_tpu_torch.utils.device import full_f32, resolve_device

logger = logging.getLogger("contrast_gan_3d_tpu_torch.validate_learning")

VESSEL_HU = {0: 400, -1: 250, 1: 550}


def synth_patient(rng, shape, vessel_hu, n_points: int = 60):
    """One synthetic scan (the JAX script's): N(50, 20) HU tissue, a sine
    centerline of ``n_points`` points with a 3^3 blob of ``vessel_hu`` +
    N(0, 10) HU around each; returns (int16 volume, uint8 mask, meta)."""
    vol = rng.normal(50.0, 20.0, shape).astype(np.float32)
    vol[0, 0, 0] = -1000
    n = n_points
    t = np.linspace(0, 1, n)
    pts = np.stack([
        (0.15 + 0.7 * t) * shape[0],
        (0.5 + 0.25 * np.sin(2 * np.pi * t)) * shape[1],
        (0.15 + 0.7 * t) * shape[2],
    ], axis=-1)
    mask = np.zeros(shape, np.uint8)
    ijk = np.clip(np.round(pts).astype(int), 0, np.asarray(shape) - 1)
    for x, y, z in ijk:
        vol[max(0, x - 1):x + 2, max(0, y - 1):y + 2, max(0, z - 1):z + 2] = vessel_hu + rng.normal(0, 10)
        mask[x, y, z] = 1
    meta = {
        "spacing": np.ones(3), "offset": np.zeros(3),
        "ostia_world": pts[:2].astype(np.float32),
        "centerlines_world": np.concatenate([pts, np.full((n, 1), 1.0)], -1).astype(np.float32),
    }
    return vol.astype(np.int16), mask, meta


def write_raw(rng, shape, raw_dir: Path, name: str, vessel_hu):
    """A synthetic scan in the raw layout: ``<name>.mhd`` with
    ``<name>/vessel0.txt`` and ``<name>/ostia.xml``."""
    vol, _, meta = synth_patient(rng, shape, vessel_hu)
    scan = raw_dir / f"{name}.mhd"
    io_utils.write_mhd(vol, scan, spacing=meta["spacing"], origin=meta["offset"])
    pdir = raw_dir / name
    pdir.mkdir(exist_ok=True)
    np.savetxt(pdir / "vessel0.txt", meta["centerlines_world"])
    (pdir / "ostia.xml").write_text(
        "<XMarkerList><ListSize>2</ListSize>"
        + "".join(f"<pos>{x} {y} {z}</pos>" for x, y, z in meta["ostia_world"])
        + "</XMarkerList>")
    return vol, meta, scan, pdir


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--iterations", type=int, default=400)
    p.add_argument("--shape", type=int, nargs=3, default=(32, 32, 32))
    p.add_argument("--patch", type=int, nargs=3, default=(16, 16, 16))
    p.add_argument("--gp", action="store_true", help="gradient-penalty mode")
    p.add_argument("--cycle-length", type=int, default=1, help="schedule iterations per fused cycle")
    p.add_argument("--family", choices=["3d", "2d"], default="3d",
                   help="2d = the conf_2d family: 2D patches and models, per-slice correction")
    p.add_argument("--out", type=Path, default=None)
    p.add_argument("--workdir", type=Path, default=None,
                   help="keep the study (cohort, checkpoint, held-out scans) here instead of a temporary directory")
    p.add_argument("--eval-cohort", type=int, default=0,
                   help="also write N held-out raw LOW scans, correct them, and write the eval lists")
    p.add_argument("--p-centerline-3d", type=float, default=0.0,
                   help="fraction of train crops centred on centerline points")
    p.add_argument("--data-format", choices=("npy", "h5"), default="npy",
                   help="patient storage driving the run (h5: one corpus file end to end; needs h5py)")
    p.add_argument("--seed", type=int, default=None, help="training seed override (the cohort stays fixed)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.family == "2d" and args.gp:
        p.error("--family 2d validates the weight-clip conf_2d stack")
    return args


def main(argv=None) -> dict:
    """Run the study in-process; returns the JSON summary."""
    args = parse_args(argv)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(name)s | %(levelname)s | %(message)s")
    device = str(resolve_device(args.device))
    if args.workdir is not None:
        tmp = Path(args.workdir)
        tmp.mkdir(parents=True, exist_ok=True)
    else:
        tmp = Path(tempfile.mkdtemp(prefix="cgan3d_validate_"))
    shape = tuple(args.shape)
    rng = np.random.default_rng(0)
    fold = []
    out_store = tmp / ("data/corpus.h5" if args.data_format == "h5" else "data")
    for label, hu in VESSEL_HU.items():
        for i in range(3):
            vol, mask, meta = synth_patient(rng, shape, hu)
            fold.append((str(write_patient(vol, mask, meta, f"s{label}_{i}", out_store)), label))

    is_2d = args.family == "2d"
    cfg = replace(
        load_config("conf_2d" if is_2d else ("gradient_penalty" if args.gp else "basic_3d")),
        train_iterations=args.iterations,
        validate_every=None,
        checkpoint_every=args.iterations,
        log_every=max(1, args.iterations // 10),
        log_images_every=None,
        train_patch_size=tuple(args.patch)[:2] if is_2d else tuple(args.patch),
        train_batch_size={0: 8, -1: 4, 1: 4} if is_2d else {0: 4, -1: 2, 1: 2},
        generator_args={"n_resnet_blocks": 2, "n_updownsample_blocks": 1, "init_channels_out": 8},
        critic_args={"init_channels_out": 4, "discriminator_depth": 2},
        # weight clipping converges fast at 1e-3; gradient penalty keeps its
        # paper's 1e-4 (a hot lr destabilizes the unnormalized critic)
        lr=1e-4 if args.gp else 1e-3,
        milestones=(),
        num_workers=(2, 1),
        logger="console",
        cycle_length=args.cycle_length,
        **({"seed": args.seed} if args.seed is not None else {}),
    )
    built = build(cfg, checkpoint_dir=str(tmp / "ckpt"), device=device)
    # one loader thread per label: the draw order, and with it the run,
    # repeats (the JAX script's two threads race for each sampler)
    loaders = create_loaders(fold, cfg.train_patch_size, cfg.train_batch_size, np.random.default_rng(built.seed),
                             num_threads=1, augmenter=built.host_augmenter,
                             p_centerline_3d=0.0 if is_2d else args.p_centerline_3d, device=device)
    trainer = Trainer(built.generator, built.critic, built.gen_tx, built.critic_tx, built.step_config,
                      built.trainer_config, seed=built.seed, logger_interface=built.logger_interface, device=device)
    with full_f32():
        trainer.fit(loaders)

    # held-out LOW and HIGH scans, corrected: LOW must rise and HIGH fall
    # toward the corridor
    corrector = CCTAContrastCorrector.from_checkpoint(
        tmp / "ckpt", generator=built.generator,
        inference_patch_size=shape[:2] if is_2d else tuple(args.patch), batch_size=4, device=device)
    lo, hi = cfg.desired_HU_bounds
    mid = (lo + hi) / 2
    summary = {
        "target_corridor": [lo, hi],
        "iterations": args.iterations,
        "mode": "gp" if args.gp else "wc",
        "family": args.family,
        "p_centerline_3d": args.p_centerline_3d,
        "data_format": args.data_format,
    }
    for tag, vessel_hu in (("", 250), ("high_", 550)):
        vol, mask, _ = synth_patient(rng, shape, vessel_hu)
        corrected = corrector(vol).cpu().numpy()
        m = mask.astype(bool)
        before, after = float(vol[m].mean()), float(corrected[m].mean())
        summary[f"{tag}centerline_mean_hu_before"] = round(before, 1)
        summary[f"{tag}centerline_mean_hu_after"] = round(after, 1)
        summary[f"{tag}moved_toward_corridor"] = bool(abs(after - mid) < abs(before - mid))
    if args.eval_cohort > 0:
        # the original-vs-corrected study's held-out raw cohort: LOW scans
        # and an OPT anchor series, the LOW ones also corrected
        raw_dir, corr_dir = tmp / "eval_raw", tmp / "eval_corrected"
        raw_dir.mkdir(parents=True, exist_ok=True)
        corr_dir.mkdir(parents=True, exist_ok=True)
        original, corrected_list = [], []
        for i in range(args.eval_cohort):
            vol, meta, scan, pdir = write_raw(rng, shape, raw_dir, f"low_{i}", 250)
            original.append([[str(scan), str(pdir), None], -1])
            cpath = corr_dir / f"low_{i}.mhd"
            corrector.save(corrector(vol), cpath, meta)
            corrected_list.append([[str(cpath), str(pdir), None], -1])
        for i in range(max(2, args.eval_cohort // 2)):
            _, _, scan, pdir = write_raw(rng, shape, raw_dir, f"opt_{i}", 400)
            original.append([[str(scan), str(pdir), None], 0])
        (tmp / "original_list.json").write_text(json.dumps(original))
        (tmp / "corrected_list.json").write_text(json.dumps(corrected_list))
        summary["eval_lists"] = {"original": str(tmp / "original_list.json"),
                                 "corrected": str(tmp / "corrected_list.json")}
    print(json.dumps(summary))
    if args.out:
        args.out.write_text(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
    sys.exit(0)
