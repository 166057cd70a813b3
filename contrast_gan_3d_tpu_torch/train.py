"""The training CLI of the port (counterpart of the JAX package's root
``train.py``):

    python -m contrast_gan_3d_tpu_torch.train --conf basic_3d \\
        --cval-splits splits.pkl --checkpoint-root runs --run-id exp1

Config (a preset name or an override file defining ``config(base)``) ->
seeds -> per-fold loaders -> ``build`` -> ``Trainer.fit``, with a graceful
stop on SIGTERM / SIGINT and an optional wall-clock budget. The splits
pickle holds ``{"train": [fold, ...], "test": [fold, ...]}``, a fold a list
of (patient path, label). Runs on the card unless ``--device cpu``. A run
whose checkpoint directory already holds checkpoints resumes from the
latest (model, optimizers, random generator and data streams).
Building folds from dataset sheets, wandb, the profiler and multi-host
runs are not ported (ROADMAP).
"""

import argparse
import logging
import pickle
import signal
import sys
import threading
import time
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import List, Optional

import numpy as np

from contrast_gan_3d_tpu_torch.data.pipeline import create_loaders
from contrast_gan_3d_tpu_torch.experiments.builder import build
from contrast_gan_3d_tpu_torch.experiments.config import ExperimentConfig, asdict_flat, load_config
from contrast_gan_3d_tpu_torch.models.utils import count_parameters
from contrast_gan_3d_tpu_torch.trainer.trainer import Trainer, install_preemption_handler
from contrast_gan_3d_tpu_torch.utils.device import full_f32, resolve_device

logger = logging.getLogger("contrast_gan_3d_tpu_torch.train")


@dataclass
class FoldRun:
    """What one fold's run leaves behind, for in-process callers."""

    trainer: Trainer
    train_loaders: dict
    val_loaders: Optional[dict]


@dataclass
class TrainManager:
    """Per-fold orchestration (the JAX ``TrainManager`` without meshes,
    wandb and the profiler)."""

    config: ExperimentConfig
    train_folds: List
    val_folds: List
    checkpoint_root: Path
    run_id: Optional[str] = None
    starting_fold: int = 0
    max_folds: int = 1
    max_hours: Optional[float] = None
    device: str = "cuda"
    runs: List[FoldRun] = field(default_factory=list)
    _t0: float = field(default_factory=time.monotonic)

    def __call__(self):
        if len(self.train_folds) != len(self.val_folds):
            raise SystemExit(f"cval splits misaligned: {len(self.train_folds)} train vs "
                             f"{len(self.val_folds)} val folds")
        for fold_idx, (train_fold, val_fold) in enumerate(zip(self.train_folds, self.val_folds)):
            if self.starting_fold <= fold_idx < self.starting_fold + self.max_folds:
                self.run_fold(fold_idx, train_fold, val_fold)
        if not self.runs:
            raise SystemExit(f"no fold ran: starting_fold={self.starting_fold} with "
                             f"{len(self.train_folds)} folds available")

    def _remaining_s(self) -> Optional[float]:
        return None if self.max_hours is None else self.max_hours * 3600.0 - (time.monotonic() - self._t0)

    def run_fold(self, fold_idx: int, train_fold, val_fold):
        cfg = self.config
        remaining = self._remaining_s()
        if remaining is not None and remaining <= 0:
            logger.warning("--max-hours budget exhausted before fold %d; skipping", fold_idx)
            return
        run_name = self.run_id or f"{cfg.name}-fold{fold_idx}"
        if self.run_id and self.max_folds > 1:
            run_name = f"{self.run_id}-fold{fold_idx}"
        ckpt_dir = Path(self.checkpoint_root) / run_name

        built = build(cfg, checkpoint_dir=str(ckpt_dir), device=self.device)
        host_rng = np.random.default_rng(built.seed)
        loader_kw = dict(to_device=True, device=self.device)
        train_loaders = create_loaders(train_fold, cfg.train_patch_size, cfg.train_batch_size, host_rng,
                                       num_threads=cfg.num_workers[0], prefetch=cfg.prefetch_depth,
                                       augmenter=built.host_augmenter,
                                       p_centerline_3d=0.0 if cfg.is_2d else cfg.p_centerline_3d,
                                       **loader_kw)
        val_loaders = None
        if cfg.validate_every is not None and val_fold:
            val_loaders = create_loaders(val_fold, cfg.val_patch_size, cfg.val_batch_size, host_rng,
                                         num_threads=cfg.num_workers[1], prefetch=1, **loader_kw)
        trainer = Trainer(built.generator, built.critic, built.gen_tx, built.critic_tx, built.step_config,
                          built.trainer_config, seed=built.seed, logger_interface=built.logger_interface,
                          device=self.device)
        logger.info("Fold %d | G params %s | D params %s | config %s", fold_idx,
                    f"{count_parameters(trainer.state.generator):,}", f"{count_parameters(trainer.state.critic):,}",
                    asdict_flat(cfg))
        prev_handlers = install_preemption_handler(trainer)
        budget_timer = None
        if remaining is not None:
            budget_timer = threading.Timer(
                self._remaining_s(), lambda: trainer.request_stop(f"--max-hours {self.max_hours} budget reached"))
            budget_timer.daemon = True
            budget_timer.start()
        try:
            # f32 work trains in full f32 (bf16 work is unaffected); the
            # switches set at a cycle's capture bind the graph that replays it
            with full_f32():
                trainer.fit(train_loaders, val_loaders)
        finally:
            if budget_timer is not None:
                budget_timer.cancel()
            for signum, handler in (prev_handlers or {}).items():
                signal.signal(signum, handler)
        self.runs.append(FoldRun(trainer, train_loaders, val_loaders))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--conf", default=None, help="preset name or python override file")
    p.add_argument("--cval-splits", required=True, help="pickle of {'train': [fold..], 'test': [fold..]}")
    p.add_argument("--checkpoint-root", required=True, help="checkpoints go to <root>/<run id>")
    p.add_argument("--run-id", default=None, help="the run's directory name (resumes if it has checkpoints)")
    p.add_argument("--starting-fold", type=int, default=0)
    p.add_argument("--max-folds", type=int, default=1)
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--max-hours", type=float, default=None,
                   help="wall-clock budget: when it expires the trainer finishes the iteration, "
                        "checkpoints and exits 0; resume with the same command")
    p.add_argument("--checkpoint-keep", type=int, default=None, help="keep only the newest N checkpoints")
    p.add_argument("--logger", choices=["file", "console", "none"], default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> TrainManager:
    """Run the CLI in-process; returns the manager (its ``runs`` hold each
    fold's trainer and loaders)."""
    args = parse_args(argv)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(name)s | %(levelname)s | %(message)s")
    device = str(resolve_device(args.device))
    cfg = load_config(args.conf)
    overrides = {k: v for k, v in (("train_iterations", args.iterations), ("checkpoint_keep", args.checkpoint_keep),
                                   ("logger", args.logger)) if v is not None}
    if overrides:
        cfg = replace(cfg, **overrides)
    with open(args.cval_splits, "rb") as fd:
        splits = pickle.load(fd)
    manager = TrainManager(cfg, splits["train"], splits["test"], checkpoint_root=Path(args.checkpoint_root),
                           run_id=args.run_id, starting_fold=args.starting_fold, max_folds=args.max_folds,
                           max_hours=args.max_hours, device=device)
    manager()
    return manager


if __name__ == "__main__":
    main()
    sys.exit(0)
