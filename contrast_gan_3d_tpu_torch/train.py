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

Data parallelism (``parallel/``): ``--dp-devices N`` trains on N cards, one
rank each (``--dp-devices 0``: every visible card), on the batches a
one-card run with the same seed trains on: every rank runs the same seeded
loaders and keeps its share of each batch. Outside torchrun the command
starts the N ranks itself; under ``torchrun --nproc-per-node N`` each
process is one. ``--multihost`` joins torchrun's multi-node group (and
implies ``--dp-devices 0``): each host samples its round-robin share of
the fold (``multihost.host_fold_shard``; a fold entry naming an HDF5
corpus file is dealt by its members, so each host reads only its own) and
its ranks split that host's batches. Train batches are rounded up to multiples of the data-parallel
ranks, as JAX's CLI rounds them. On the CPU (``--device cpu``) the ranks
are gloo processes. ``--sp-devices S`` (JAX's dp x sp mesh) also splits
each patch's first dim (each 2D slice's, for the 2D presets) over S ranks,
which exchange conv halos
(``parallel/spatial.py``): ``D x S`` ranks in all, D from ``--dp-devices``
(1 when neither it nor the config sets it; 0: every visible card over
S), one card each (NCCL), gloo processes on the CPU. The first dims of
the train and validation patches must divide S.

``--debug`` turns on autograd's anomaly mode and checks every step's
metrics for NaN / inf (``utils/debug.py``); anomaly mode cannot run in a
captured CUDA graph, so ``--debug`` dispatches every iteration eagerly
(``cycle_length`` 1) and logs it. ``--profiler-dir`` traces steps with
``torch.profiler`` (the first ``--profiler-steps``, or a
``--profiler-schedule``) into Chrome traces there.
Without ``--cval-splits`` the folds are one stratified split of the
config's ``dataset_paths`` csv sheets (``data/labeling.cross_val_splits``,
the JAX CLI's fallback). ``--logger`` picks the experiment logger
(``experiments/builder.py``); under several ranks only rank 0 keeps a
file, TensorBoard or wandb logger. With ``--logger wandb`` each fold
starts its wandb run before ``build`` (named for the run id, ``-fold<i>``
past one fold; ``--wandb-project``, ``--wandb-entity``) and finishes it
after, and a ``--run-id`` resumes that run's group and starting fold, as
the JAX CLI does; where wandb fails to start, training goes on.
"""

import argparse
import logging
import os
import pickle
import signal
import sys
import threading
import time
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from contrast_gan_3d_tpu_torch.data.labeling import cross_val_splits
from contrast_gan_3d_tpu_torch.data.pipeline import create_loaders
from contrast_gan_3d_tpu_torch.experiments.builder import build
from contrast_gan_3d_tpu_torch.experiments.config import ExperimentConfig, asdict_flat, load_config
from contrast_gan_3d_tpu_torch.models.utils import count_parameters
from contrast_gan_3d_tpu_torch.parallel import multihost
from contrast_gan_3d_tpu_torch.parallel.mesh import DataMesh, data_mesh, dp_sp_mesh, spawn_ranks
from contrast_gan_3d_tpu_torch.trainer.trainer import HIGH, LOW, OPT, Trainer, install_preemption_handler
from contrast_gan_3d_tpu_torch.utils.debug import enable_nan_debugging
from contrast_gan_3d_tpu_torch.utils.device import full_f32, resolve_device
from contrast_gan_3d_tpu_torch.utils import memory as memory_lib

logger = logging.getLogger("contrast_gan_3d_tpu_torch.train")


@dataclass
class FoldRun:
    """What one fold's run leaves behind, for in-process callers."""

    trainer: Trainer
    train_loaders: dict
    val_loaders: Optional[dict]


def round_train_batches(bs: dict, n: int) -> dict:
    """The least rounding of the train batch sizes for ``n`` data-parallel
    ranks, as JAX's CLI rounds them: the Trainer needs only ``opt % n ==
    0`` and ``(LOW + HIGH) % n == 0``; the sub-optimal pad splits as evenly
    as it can over LOW and HIGH."""
    subopt = bs.get(LOW, 0) + bs.get(HIGH, 0)
    opt_b = bs.get(OPT, 0)
    if not (opt_b % n or subopt % n):
        return dict(bs)
    new_bs = dict(bs)
    if opt_b % n:
        new_bs[OPT] = -(-opt_b // n) * n
    extra = (-subopt) % n
    new_bs[LOW] = bs.get(LOW, 0) + (extra - extra // 2)
    new_bs[HIGH] = bs.get(HIGH, 0) + extra // 2
    return new_bs


def make_profiler(out_dir, steps: int = 20, schedule: Optional[str] = None) -> torch.profiler.profile:
    """A ``torch.profiler.profile`` that traces the first ``steps`` steps, or
    ``schedule`` (``"skip_first=500,active=10[,wait=..,warmup=..,repeat=..]"``,
    ``torch.profiler.schedule``'s arguments; repeat defaults to 1), and
    writes each traced window as a Chrome trace into ``out_dir``. On the
    card it also records the allocator's history over each window (from
    its first warm-up or traced step) and writes it after the window as
    ``memory_step<N>.pickle`` beside the live-block table
    ``memory_step<N>.txt`` (``utils/memory.write_memory_snapshot``), the
    counterpart of the JAX CLI's memory profile. CPU and, on the card, CUDA
    activity, with memory."""
    kwargs = dict(wait=0, warmup=0, active=steps, repeat=1, skip_first=0)
    if schedule:
        for part in schedule.split(","):
            if part.strip():
                k, v = part.split("=")
                if k.strip() not in kwargs:
                    raise ValueError(f"--profiler-schedule: unknown key {k.strip()!r} (expected {sorted(kwargs)})")
                kwargs[k.strip()] = int(v)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    write_trace = torch.profiler.tensorboard_trace_handler(str(out_dir))
    windows = torch.profiler.schedule(**kwargs)
    recording = False

    def schedule_fn(step: int) -> torch.profiler.ProfilerAction:
        nonlocal recording
        action = windows(step)
        if action != torch.profiler.ProfilerAction.NONE and not recording:
            recording = memory_lib.record_memory_history(True)
        return action

    def on_trace_ready(prof):
        nonlocal recording
        write_trace(prof)
        memory_lib.write_memory_snapshot(out_dir, f"step{prof.step_num}")
        if recording:
            memory_lib.record_memory_history(False)
            recording = False

    return torch.profiler.profile(activities=activities, schedule=schedule_fn, on_trace_ready=on_trace_ready,
                                  profile_memory=True, record_shapes=True)


@dataclass
class TrainManager:
    """Per-fold orchestration (the JAX ``TrainManager``).
    ``mesh``: this rank's ``DataMesh`` in a data-parallel run."""

    config: ExperimentConfig
    train_folds: List
    val_folds: List
    checkpoint_root: Path
    run_id: Optional[str] = None
    starting_fold: int = 0
    max_folds: int = 1
    max_hours: Optional[float] = None
    device: str = "cuda"
    mesh: Optional[DataMesh] = None
    profiler_factory: Optional[object] = None  # () -> torch.profiler.profile
    wandb_project: Optional[str] = None
    wandb_entity: Optional[str] = None
    group: Optional[str] = None
    runs: List[FoldRun] = field(default_factory=list)
    _t0: float = field(default_factory=time.monotonic)

    def maybe_restore_wandb_run(self):
        """Resuming a named wandb run restores its group and starting fold
        from the wandb API, as the JAX CLI does."""
        if self.run_id is None or self.config.logger != "wandb":
            return
        try:
            import wandb

            run = wandb.Api().run("/".join(p for p in (self.wandb_entity, self.wandb_project, self.run_id) if p))
        except Exception as e:  # no wandb, no service: a fresh run state
            logger.warning("wandb resume lookup failed (%s); fresh run state", e)
            return
        self.group = getattr(run, "group", None) or self.group
        fold = (getattr(run, "config", None) or {}).get("fold")
        if fold is not None:
            self.starting_fold = int(fold)
        logger.info("Resumed wandb run '%s': group=%s starting_fold=%d", self.run_id, self.group, self.starting_fold)

    def _start_wandb(self, cfg: ExperimentConfig, run_name: str, fold_idx: int):
        """The fold's wandb run, before ``build`` (the logger defines its
        step metric on the active run): an explicit run id names it (one
        per fold past one fold), else wandb makes one up."""
        try:
            import wandb

            wandb.init(id=(run_name if self.max_folds > 1 else self.run_id) if self.run_id else None,
                       resume="allow" if self.run_id else None, name=run_name, project=self.wandb_project,
                       entity=self.wandb_entity, group=self.group, config=asdict_flat(cfg) | {"fold": fold_idx})
        except Exception as e:  # a tracker that fails to start must not stop training
            logger.warning("wandb init failed (%s); continuing", e)

    @staticmethod
    def _finish_wandb():
        """Close the fold's run, or the next fold's init would join it."""
        try:
            import wandb

            if wandb.run is not None:
                wandb.finish()
        except Exception:  # as JAX's: nothing to close
            pass

    def __call__(self):
        self.maybe_restore_wandb_run()
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
        """The --max-hours budget left; under a mesh rank 0's, so that every
        rank makes the same decision."""
        if self.max_hours is None:
            return None
        remaining = self.max_hours * 3600.0 - (time.monotonic() - self._t0)
        if self.mesh is not None:
            t = torch.tensor([remaining], dtype=torch.float64, device=self.mesh.device)
            dist.broadcast(t, src=0, group=self.mesh.group)
            remaining = float(t.item())
        return remaining

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

        mesh = self.mesh
        loader_train_bs, loader_val_bs = dict(cfg.train_batch_size), dict(cfg.val_batch_size)
        if mesh is not None:
            rounded = round_train_batches(loader_train_bs, mesh.data_size)
            if rounded != loader_train_bs:
                logger.warning("Rounding train batch sizes %s -> %s to divide the %d data-parallel ranks",
                               loader_train_bs, rounded, mesh.data_size)
                cfg = replace(cfg, train_batch_size=rounded)
                loader_train_bs = dict(rounded)
            if mesh.hosts > 1:
                bad = {k: v for k, v in loader_train_bs.items() if v % mesh.hosts}
                if bad:
                    raise SystemExit(f"train batch sizes {bad} must be divisible by the {mesh.hosts} hosts (each "
                                     f"host loads its share)")
                train_fold = multihost.host_fold_shard(train_fold, mesh.host_index, mesh.hosts)
                if val_fold:
                    val_fold = multihost.host_fold_shard(val_fold, mesh.host_index, mesh.hosts)
                loader_train_bs = {k: v // mesh.hosts for k, v in loader_train_bs.items()}
                loader_val_bs = {k: max(1, v // mesh.hosts) for k, v in loader_val_bs.items()}
                logger.info("Host %d/%d: %d-patient fold shard, per-host train batches %s", mesh.host_index,
                            mesh.hosts, len(train_fold), loader_train_bs)
            if mesh.rank != 0 and cfg.logger in ("wandb", "tensorboard", "file"):
                cfg = replace(cfg, logger="none")  # rank 0 writes the metrics
        if cfg.logger == "wandb":
            self._start_wandb(cfg, run_name, fold_idx)

        built = build(cfg, checkpoint_dir=str(ckpt_dir), device=self.device)
        host_rng = np.random.default_rng(built.seed)
        if mesh is not None and mesh.hosts > 1:
            # the hosts sample disjoint patients; their streams differ too
            host_rng = host_rng.spawn(mesh.hosts)[mesh.host_index]
        # under a mesh a rank moves only its share of each batch (Trainer._assemble)
        loader_kw = dict(to_device=mesh is None, device=self.device)
        train_loaders = create_loaders(train_fold, cfg.train_patch_size, loader_train_bs, host_rng,
                                       num_threads=cfg.num_workers[0], prefetch=cfg.prefetch_depth,
                                       augmenter=built.host_augmenter,
                                       p_centerline_3d=0.0 if cfg.is_2d else cfg.p_centerline_3d,
                                       **loader_kw)
        val_loaders = None
        if cfg.validate_every is not None and val_fold:
            val_loaders = create_loaders(val_fold, cfg.val_patch_size, loader_val_bs, host_rng,
                                         num_threads=cfg.num_workers[1], prefetch=1, **loader_kw)
        trainer = Trainer(built.generator, built.critic, built.gen_tx, built.critic_tx, built.step_config,
                          built.trainer_config, seed=built.seed, logger_interface=built.logger_interface,
                          device=self.device, mesh=mesh)
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
            profiler = self.profiler_factory() if self.profiler_factory and trainer.is_writer else None
            with full_f32():
                trainer.fit(train_loaders, val_loaders, profiler=profiler)
        finally:
            if budget_timer is not None:
                budget_timer.cancel()
            for signum, handler in (prev_handlers or {}).items():
                signal.signal(signum, handler)
            if cfg.logger == "wandb":
                self._finish_wandb()
        self.runs.append(FoldRun(trainer, train_loaders, val_loaders))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--conf", default=None, help="preset name or python override file")
    p.add_argument("--cval-splits", default=None,
                   help="pickle of {'train': [fold..], 'test': [fold..]}; without it, one stratified split of the "
                        "config's dataset_paths sheets (seeded with its seed)")
    p.add_argument("--checkpoint-root", required=True, help="checkpoints go to <root>/<run id>")
    p.add_argument("--run-id", default=None, help="the run's directory name (resumes if it has checkpoints)")
    p.add_argument("--starting-fold", type=int, default=0)
    p.add_argument("--max-folds", type=int, default=1)
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--max-hours", type=float, default=None,
                   help="wall-clock budget: when it expires the trainer finishes the iteration, "
                        "checkpoints and exits 0; resume with the same command")
    p.add_argument("--checkpoint-keep", type=int, default=None, help="keep only the newest N checkpoints")
    p.add_argument("--cycle-length", type=int, default=None,
                   help="schedule iterations per dispatch. Omitted: auto (the schedule period, 5 for every preset "
                        "but train_generator_more, when every cadence divides it; replayed as one CUDA graph on "
                        "the card). 1 forces per-iteration dispatch; K > 1 forces K")
    p.add_argument("--logger", choices=["wandb", "tensorboard", "file", "console", "none"], default=None)
    p.add_argument("--wandb-project", default=None)
    p.add_argument("--wandb-entity", default=None)
    p.add_argument("--dp-devices", type=int, default=None,
                   help="data-parallel over N cards, one rank each (0 = every visible card); on the CPU, N gloo "
                        "ranks")
    p.add_argument("--sp-devices", type=int, default=None,
                   help="additionally spatially partition each patch's first dim over N ranks (dp x sp mesh: the "
                        "convs exchange halos between the slabs, in either generator layout; 'auto' takes the "
                        "direct one where a packed slab would not hold whole blocks)")
    p.add_argument("--multihost", action="store_true",
                   help="join torchrun's multi-node process group (one torchrun per host); each host samples its "
                        "share of the fold and its ranks split its batches. Implies --dp-devices 0")
    p.add_argument("--profiler-dir", default=None, help="write torch.profiler Chrome traces here")
    p.add_argument("--profiler-steps", type=int, default=20, help="trace the first N steps")
    p.add_argument("--profiler-schedule", default=None,
                   help="'skip_first=500,active=10[,wait=..,warmup=..,repeat=..]' (torch.profiler.schedule); "
                        "with cycles a step is one cycle")
    p.add_argument("--debug", action="store_true",
                   help="autograd anomaly mode and a finite check of every step's metrics; dispatches every "
                        "iteration eagerly (no CUDA graphs)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.dp_devices is not None and args.dp_devices < 0:
        p.error("--dp-devices must be >= 0")
    if args.sp_devices is not None and args.sp_devices < 1:
        p.error("--sp-devices must be >= 1")
    if args.dp_devices and args.device != "cpu" and torch.cuda.is_available() \
            and args.dp_devices > torch.cuda.device_count() and "RANK" not in os.environ:
        p.error(f"--dp-devices {args.dp_devices}: only {torch.cuda.device_count()} CUDA devices are visible")
    if args.dp_devices == 0 and args.device == "cpu" and not args.multihost:
        p.error("--dp-devices 0 means every visible card; on the CPU give the number of ranks")
    return args


def main(argv=None) -> Optional[TrainManager]:
    """Run the CLI in-process; returns the manager (its ``runs`` hold each
    fold's trainer and loaders), or None in the process that started the
    data-parallel ranks (they ran the folds)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(name)s | %(levelname)s | %(message)s")
    device = str(resolve_device(args.device))
    cfg = load_config(args.conf)
    if args.multihost and args.dp_devices is None and args.sp_devices is None and cfg.dp_devices is None \
            and not cfg.sp_devices:
        # --multihost means one model over every host: data-parallel over
        # every device, not one independent run per host
        logger.info("--multihost without a mesh config: defaulting --dp-devices 0")
        args.dp_devices = 0
    overrides = {k: v for k, v in (("train_iterations", args.iterations), ("checkpoint_keep", args.checkpoint_keep),
                                   ("logger", args.logger), ("cycle_length", args.cycle_length),
                                   ("dp_devices", args.dp_devices), ("sp_devices", args.sp_devices))
                 if v is not None}
    if args.sp_devices is not None and args.dp_devices is None and cfg.dp_devices is None:
        overrides["dp_devices"] = 1  # pure spatial partitioning
    if overrides:
        cfg = replace(cfg, **overrides)
    if not args.cval_splits and cfg.dataset_paths and cfg.seed is None and cfg.dp_devices is not None:
        # each rank splits the sheets itself: unseeded, they would draw
        # different folds
        raise SystemExit("data-parallel folds from dataset_paths need the config's seed, so that every rank "
                         "draws the same split")
    backend = "gloo" if torch.device(device).type == "cpu" else "nccl"
    mesh = None
    owns_group = False
    space = cfg.sp_devices or 1
    if space > 1:
        for size_field in ("train_patch_size", "val_patch_size"):
            first_dim = getattr(cfg, size_field)[0]
            if first_dim % space:
                raise SystemExit(f"{size_field}[0]={first_dim} must be divisible by sp_devices={space}")
    if cfg.dp_devices is not None or space > 1:
        if not dist.is_initialized():
            if "RANK" not in os.environ and not args.multihost:
                # no launcher: start the ranks here, one per card
                visible = torch.cuda.device_count()
                n = (cfg.dp_devices or visible // space) * space
                if n < space or (backend == "nccl" and n > visible):
                    raise SystemExit(f"dp_devices={cfg.dp_devices} x sp_devices={space} gives {n} ranks: it needs "
                                     f"at least {space}, and on cards no more than the {visible} visible")
                logger.info("Starting %d ranks (%s%s)", n, backend, f", {n // space} x {space} dp x sp"
                            if space > 1 else "")
                spawn_ranks(main, n, (argv,), backend=backend)
                return None
            multihost.initialize(backend)
            owns_group = True
        host, hosts = multihost.host_topology()
        mesh_device = None if backend == "nccl" else "cpu"
        if space > 1:
            mesh = dp_sp_mesh(cfg.dp_devices or dist.get_world_size() // space, space, device=mesh_device,
                              hosts=hosts)
        else:
            mesh = data_mesh(cfg.dp_devices or None, device=mesh_device, hosts=hosts)
        device = str(mesh.device)
        logger.info("Rank %d/%d on %s (host %d/%d, %d x %d dp x sp)", mesh.rank, mesh.world_size, device, host,
                    hosts, mesh.data_size, mesh.space)
    anomaly = torch.is_anomaly_enabled()
    if args.debug:
        enable_nan_debugging()
        logger.warning("--debug: autograd anomaly mode cannot run inside a captured CUDA graph; every iteration "
                       "dispatches eagerly (cycle_length %s -> 1), and every step's metrics are checked for NaN / "
                       "inf", cfg.cycle_length if cfg.cycle_length is not None else "auto")
        cfg = replace(cfg, cycle_length=1)
    if args.cval_splits:
        with open(args.cval_splits, "rb") as fd:
            splits = pickle.load(fd)
    elif cfg.dataset_paths:
        train_folds, val_folds = cross_val_splits(1, *cfg.dataset_paths, seed=cfg.seed)
        splits = {"train": train_folds, "test": val_folds}
    else:
        raise SystemExit("Provide --cval-splits or config dataset_paths")
    profiler_factory = None
    if args.profiler_dir:
        profiler_factory = lambda: make_profiler(args.profiler_dir, args.profiler_steps, args.profiler_schedule)
    manager = TrainManager(cfg, splits["train"], splits["test"], checkpoint_root=Path(args.checkpoint_root),
                           run_id=args.run_id, starting_fold=args.starting_fold, max_folds=args.max_folds,
                           max_hours=args.max_hours, device=device, mesh=mesh, profiler_factory=profiler_factory,
                           wandb_project=args.wandb_project, wandb_entity=args.wandb_entity)
    try:
        manager()
    finally:
        enable_nan_debugging(anomaly)
        if owns_group:
            dist.destroy_process_group()
    return manager


if __name__ == "__main__":
    main()
    sys.exit(0)
