"""Turn an :class:`ExperimentConfig` into runnable objects: models,
optimizers, step and trainer configs, the host augmenter and the logger
(counterpart of ``contrast_gan_3d_tpu/experiments/builder.py``).

What the JAX builder chooses automatically, the port resolves so:
- ``generator_layout="auto"`` -> "packed" (``models/generator.py``'s
  block-space layout) for a 3D batch-norm generator with at least one
  down/upsample block whose train and validation patch dims are multiples
  of ``max(4, 2**n)`` and at least 8 (every 3D preset), else "direct", as
  the JAX builder resolves it; ``generator_args["layout"]`` wins over
  ``generator_layout``;
- ``cycle_length`` None -> ``resolve_cycle_length``, as the JAX builder
  resolves it: K = ``train_generator_every`` when every host cadence is a
  multiple of it (nine of the ten presets: K = 5), else 1
  (``train_generator_more``: 1). The card runs each K-iteration cycle as a
  replayed CUDA graph, the CPU as the loop over the iterations;
- ``remat``: an explicit True or False is honoured (``generator_args`` /
  ``critic_args`` "remat" win, as in JAX), and both networks run their
  blocks under ``models/blocks.remat``. None stays off on this card, where
  the JAX builder turns it on above 30 M voxels per iteration in 3D
  (``small_patch``, ``rmsprop`` and ``gp_layernorm``: 40 + 20 + 20 patches
  of 128x128x32, 41.9 M voxels), a threshold set for a 16 GB chip:
  ``small_patch``'s bf16 ``combined_step`` peaks at 8.28 GiB allocated on
  an NVIDIA H100 80GB HBM3 at 700 W (``chip_smoke.py``'s small_patch
  phase), a tenth of the card. The builder logs where JAX's rule would have
  turned it on. Remat changes memory, not results;
- ``dp_devices`` and ``sp_devices`` are the train CLI's: it starts the
  ranks and builds the (dp x sp) mesh (``parallel/mesh.py``), and each
  rank builds the same models here. Under ``sp_devices`` either layout
  exchanges conv halos between the slabs (``parallel/spatial.py``; the
  packed layout in block rows), and ``generator_layout="auto"`` resolves
  as without it, but where a slab of the packed layout would not hold
  whole blocks at every stage (``models/generator.packed_slab_note``):
  "auto" is then "direct" (logged) and an explicit "packed" raises,
  naming the slabs' rows. The 2D family splits its slices' first dim (H
  of NCHW) the same way, on the direct layout;
- ``augment_backend="device"`` -> ``StepConfig.augment``; ``"host"`` -> a
  ``HostAugmenter`` (2D: ``HostAugmenter2D``) for the train loaders. The
  JAX builder falls back to the device augmentation where its native
  library does not build; the port's builds or raises;
- ``is_2d`` (the 2D family) -> both networks with ``ndim=2``, an
  ``Augment2DConfig`` (rotation and mirror) and the 2D loggers, which
  render the batch as one slice grid;
- ``logger`` -> the JAX builder's loggers, each inside a
  ``MultiThreadedLogger`` with ``np.random.default_rng(seed)``: "file" ->
  ``FileLogger`` (``FileLogger2D``) under ``<checkpoint_dir>/metrics``, or
  ``<LOGS_DIR>/<name>/metrics`` without a checkpoint dir (``config.py``);
  "tensorboard" -> ``TensorBoardLogger`` (2D) under ``<checkpoint_dir>/tb``
  or ``<LOGS_DIR>/<name>/tb`` (it needs ``tensorboardX``); "wandb" ->
  ``WandbLogger`` (2D), or ``ConsoleLogger`` (logged) where wandb cannot be
  imported; "console" and "none" as named; any other name raises.

The networks' initial weights are drawn on the CPU from the config's seed
(torch initialises a module when it is built, where the JAX package draws
them from a key in ``init_state``), from flax's distributions
(``models/utils.init_like_flax``), then move to ``device``.
"""

import dataclasses
import logging
from dataclasses import dataclass
from functools import partial
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from contrast_gan_3d_tpu_torch import config as paths
from contrast_gan_3d_tpu_torch.data.augment import Augment2DConfig, AugmentConfig
from contrast_gan_3d_tpu_torch.data.host_augment import HostAugmenter, HostAugmenter2D
from contrast_gan_3d_tpu_torch.data.scaler import FactorZeroCenterScaler
from contrast_gan_3d_tpu_torch.experiments.config import DEFAULT_SEED, ExperimentConfig
from contrast_gan_3d_tpu_torch.models.discriminator import PatchGANDiscriminator
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator, packed_slab_note
from contrast_gan_3d_tpu_torch.trainer.logger import (
    ConsoleLogger,
    FileLogger,
    FileLogger2D,
    LoggerInterface,
    MultiThreadedLogger,
    NoopLogger,
    TensorBoardLogger,
    TensorBoardLogger2D,
    WandbLogger,
    WandbLogger2D,
    has_wandb,
)
from contrast_gan_3d_tpu_torch.trainer.optim import make_optimizer
from contrast_gan_3d_tpu_torch.trainer.steps import StepConfig
from contrast_gan_3d_tpu_torch.trainer.trainer import TrainerConfig
from contrast_gan_3d_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the loggers that write under a directory: (its name, 3D class, 2D class)
_DIR_LOGGERS = {"file": ("metrics", FileLogger, FileLogger2D),
                "tensorboard": ("tb", TensorBoardLogger, TensorBoardLogger2D)}


@dataclass
class BuiltExperiment:
    config: ExperimentConfig
    generator: nn.Module
    critic: nn.Module
    gen_tx: Callable    # params -> ScheduledOptimizer
    critic_tx: Callable
    step_config: StepConfig
    trainer_config: TrainerConfig
    scaler: FactorZeroCenterScaler
    logger_interface: LoggerInterface
    seed: int
    host_augmenter: Optional[HostAugmenter] = None  # or HostAugmenter2D


def resolve_cycle_length(cfg: ExperimentConfig, stop_sync_every: Optional[int] = None) -> int:
    """Resolve ``cfg.cycle_length`` (None = auto) to a concrete K, as the
    JAX builder does: auto picks the schedule period
    ``train_generator_every`` when every host-visible cadence (log, image
    log, validation, checkpoint, stop sync) is a multiple of it, so each
    fires at a cycle boundary that is its due iteration; otherwise 1.
    Explicit values are kept (at least 1). ``stop_sync_every`` is the
    value the trainer runs with (``TrainerConfig``'s default otherwise)."""
    if cfg.cycle_length is not None:
        return max(1, int(cfg.cycle_length))
    k = int(cfg.train_generator_every or 0)
    if k <= 1:
        return 1
    if stop_sync_every is None:
        stop_sync_every = TrainerConfig.stop_sync_every
    # train_critic_every need not divide: the critic and generator branch
    # inside the cycle's pattern, per iteration
    cadences = (cfg.log_every, cfg.log_images_every, cfg.validate_every, cfg.checkpoint_every, stop_sync_every)
    if any(c is not None and c % k for c in cadences):
        return 1
    logger.info("cycle_length auto: %d-iteration schedule cycles (every cadence divides; pass cycle_length=1 to "
                "disable)", k)
    return k


def resolve_layout(cfg: ExperimentConfig) -> str:
    """The generator layout, as the JAX builder resolves it: an explicit
    ``generator_args["layout"]`` wins over ``generator_layout``; "auto" is
    "packed" where the packed layout's guards and the patch sizes allow it
    (dims a multiple of the block for the stage strides, at least 8 for the
    packed reflect pad's (L+1)-block slabs), else "direct". Under
    ``sp_devices`` the same guards hold for each X-slab of the patches:
    where one breaks them, "auto" is "direct" (logged) and "packed"
    raises."""
    layout = cfg.generator_args.get("layout", cfg.generator_layout)
    n = cfg.generator_args.get("n_updownsample_blocks", 2)
    if layout == "auto":
        block = max(4, 2**n)
        eligible = (
            not cfg.is_2d
            and cfg.generator_args.get("norm", "batch") == "batch"
            and n >= 1
            and all(p % block == 0 and p >= 8 for p in (*cfg.train_patch_size, *cfg.val_patch_size))
        )
        resolved = "packed" if eligible else "direct"
    else:
        resolved = layout
    space = cfg.sp_devices or 1
    if resolved == "packed" and space > 1 and not cfg.is_2d:
        notes = [packed_slab_note(p[0], space, n) for p in (cfg.train_patch_size, cfg.val_patch_size)]
        note = next((m for m in notes if m is not None), None)
        if note is not None and layout == "packed":
            raise ValueError(f"{cfg.name}: sp_devices={space}: {note}")
        if note is not None:
            logger.info("%s: generator_layout auto -> direct under sp_devices=%d: %s", cfg.name, space, note)
            return "direct"
    return resolved


REMAT_VOXELS = 30_000_000  # the JAX builder's remat threshold, per iteration
_remat_logged = set()


def resolve_remat(cfg: ExperimentConfig) -> bool:
    """``cfg.remat`` when set; None is off (see the module docstring), with
    one log line per config name where the JAX builder's rule would turn it
    on."""
    if cfg.remat is not None:
        return bool(cfg.remat)
    voxels = sum(cfg.train_batch_size.values()) * int(np.prod(cfg.train_patch_size))
    if not cfg.is_2d and voxels > REMAT_VOXELS and cfg.name not in _remat_logged:
        _remat_logged.add(cfg.name)
        logger.info("%s: remat stays off: the JAX builder turns it on above %d voxels per iteration (%d here) "
                    "for a 16 GB chip; this card holds the step without it (pass remat=True to force it)",
                    cfg.name, REMAT_VOXELS, voxels)
    return False


def _check_portable(cfg: ExperimentConfig):
    """Raise for a backend the port does not know."""
    if cfg.augment_backend not in ("host", "device"):
        raise ValueError(f"unknown augment_backend {cfg.augment_backend!r}: expected host | device")
    if cfg.logger not in ("wandb", "tensorboard", "file", "console", "none"):
        # a typo must not silently turn off a long run's logging
        raise ValueError(f"unknown logger {cfg.logger!r}: expected wandb | tensorboard | file | console | none")


def build(cfg: ExperimentConfig, checkpoint_dir: Optional[str] = None, device="cuda") -> BuiltExperiment:
    _check_portable(cfg)
    device = resolve_device(device)
    dtype = _DTYPES[cfg.compute_dtype]
    ndim = 2 if cfg.is_2d else 3
    layout = resolve_layout(cfg)
    remat = resolve_remat(cfg)
    gen_args = {k: v for k, v in cfg.generator_args.items() if k != "layout"}
    seed = DEFAULT_SEED if cfg.seed is None else cfg.seed
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        generator = ResnetGenerator(**{**dict(ndim=ndim, dtype=dtype, remat=remat), **gen_args, "layout": layout})
        critic = PatchGANDiscriminator(**{**dict(ndim=ndim, dtype=dtype, remat=remat), **cfg.critic_args})
    generator.to(device)
    critic.to(device)
    tx = partial(make_optimizer, cfg.optimizer, lr=cfg.lr, betas=cfg.betas, milestones=cfg.milestones,
                 lr_gamma=cfg.lr_gamma)
    scaler = FactorZeroCenterScaler(*cfg.HU_norm_range, cfg.max_HU_delta)

    augment = host_augmenter = None
    if cfg.augment and cfg.is_2d:
        augment = Augment2DConfig(do_rotation=cfg.do_rotation, angle=float(np.deg2rad(cfg.rotation_deg)),
                                  p_rotation=cfg.p_rotation)
    elif cfg.augment:
        augment = AugmentConfig(
            do_elastic=cfg.do_elastic, deformation_scale=cfg.deformation_scale, p_elastic=cfg.p_elastic,
            do_scale=cfg.do_scale, scale_range=cfg.scale_range, p_scale=cfg.p_scale,
            do_rotation=cfg.do_rotation, angle=float(np.deg2rad(cfg.rotation_deg)), p_rotation=cfg.p_rotation,
        )
    if augment is not None and cfg.augment_backend == "host":
        host_augmenter = (HostAugmenter2D if cfg.is_2d else HostAugmenter)(augment, np.random.default_rng(seed))
        augment = None  # the warp happens in the loaders' workers

    step_config = StepConfig(
        weight_clip=cfg.weight_clip,
        gp_weight=cfg.gp_weight,
        hu_bounds=tuple(float(b) for b in cfg.desired_HU_bounds),
        scaler=scaler,
        augment=augment,
        dtype=dtype,
    )
    trainer_config = TrainerConfig(
        train_iterations=cfg.train_iterations,
        train_critic_every=cfg.train_critic_every,
        train_generator_every=cfg.train_generator_every,
        val_every=cfg.validate_every,
        val_iterations=cfg.val_iterations,
        log_every=cfg.log_every,
        log_images_every=cfg.log_images_every,
        checkpoint_every=cfg.checkpoint_every,
        checkpoint_keep=cfg.checkpoint_keep,
        checkpoint_dir=checkpoint_dir,
    )
    # resolved against the stop_sync_every this TrainerConfig carries
    trainer_config = dataclasses.replace(
        trainer_config, cycle_length=resolve_cycle_length(cfg, trainer_config.stop_sync_every))
    rng = np.random.default_rng(seed)
    if cfg.logger == "wandb" and has_wandb():
        wandb_cls = WandbLogger2D if cfg.is_2d else WandbLogger
        logger_interface: LoggerInterface = MultiThreadedLogger(wandb_cls(scaler, rng=rng))
    elif cfg.logger in _DIR_LOGGERS:
        sub, cls_3d, cls_2d = _DIR_LOGGERS[cfg.logger]
        # beside the checkpoints, or under the project's logs directory
        out_dir = Path(checkpoint_dir) / sub if checkpoint_dir else paths.LOGS_DIR / cfg.name / sub
        logger_interface = MultiThreadedLogger((cls_2d if cfg.is_2d else cls_3d)(scaler, out_dir, rng=rng))
    elif cfg.logger == "wandb":  # wandb cannot be imported
        logger.info("%s: logger wandb -> console (wandb is not installed)", cfg.name)
        logger_interface = ConsoleLogger()
    elif cfg.logger == "console":
        logger_interface = ConsoleLogger()
    else:
        logger_interface = NoopLogger()
    return BuiltExperiment(
        config=cfg, generator=generator, critic=critic, gen_tx=tx, critic_tx=tx,
        step_config=step_config, trainer_config=trainer_config, scaler=scaler,
        logger_interface=logger_interface, seed=seed, host_augmenter=host_augmenter,
    )
