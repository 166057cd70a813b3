"""Typed experiment configuration and the preset registry (the port's own
copy of ``contrast_gan_3d_tpu/experiments/config.py``: the same field
names, defaults and presets, without the XLA compiler options).

Every preset builds its config; ``experiments/builder.py`` decides what
the port can run (the 2D family and the layer-norm critic raise there).
``load_config`` resolves a preset name or a python file that defines
``config(base) -> ExperimentConfig`` or a module-level ``CONFIG``.
"""

import dataclasses
import importlib.util
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

from contrast_gan_3d_tpu_torch.constants import MAX_HU, MIN_HU

# reference constants.py (the JAX package's constants.py)
MAX_HU_DELTA = 600
DESIRED_HU_BOUNDS = (350, 450)
TRAIN_PATCH_SIZE = (128, 128, 128)
VAL_PATCH_SIZE = (256, 256, 128)
DEFAULT_SEED = 42


@dataclass(frozen=True)
class ExperimentConfig:
    name: str = "basic_3d"

    # schedule (reference basic_conf.py:22-30)
    train_iterations: int = 10_000
    val_iterations: int = 2
    train_generator_every: int = 5
    train_critic_every: int = 1
    seed: Optional[int] = None  # None -> DEFAULT_SEED at runtime
    checkpoint_every: Optional[int] = 1000
    # keep only the newest N checkpoints (+ their data sidecars); None =
    # keep all, the reference behavior (it never prunes, Trainer.py:321-327)
    checkpoint_keep: Optional[int] = None
    validate_every: Optional[int] = 400
    log_every: Optional[int] = 100
    log_images_every: Optional[int] = 500

    # optimizer (basic_conf.py:33-37; GP variant gradient_penalty_conf.py:7-11)
    optimizer: str = "adam"  # adam | rmsprop | sgd
    lr: float = 2e-4
    betas: Tuple[float, float] = (0.5, 0.999)
    milestones: Tuple[int, ...] = (6000, 8000)
    lr_gamma: float = 0.1

    # WGAN mode
    weight_clip: Optional[float] = 0.01  # None -> gradient penalty
    gp_weight: float = 10.0

    # HU semantics (basic_conf.py:39-43)
    max_HU_delta: int = MAX_HU_DELTA
    desired_HU_bounds: Tuple[int, int] = DESIRED_HU_BOUNDS
    HU_norm_range: Tuple[int, int] = (MIN_HU, MAX_HU)

    # models (basic_conf.py:49-66)
    is_2d: bool = False
    generator_args: Dict[str, Any] = field(
        default_factory=lambda: {
            "n_resnet_blocks": 4,
            "n_updownsample_blocks": 2,
            "init_channels_out": 16,
        }
    )
    critic_args: Dict[str, Any] = field(
        default_factory=lambda: {
            "init_channels_out": 8,
            "discriminator_depth": 3,
            "negative_slope": 0.2,
        }
    )
    # compute dtype of both networks; parameters, optimizer state and
    # BatchNorm statistics stay f32 (float32 = the strict-parity mode)
    compute_dtype: str = "bfloat16"
    # generator layout: "auto" resolves as in the JAX builder ("packed" for
    # every 3D preset, "direct" for the 2D family); "direct" / "packed"
    # force one; generator_args["layout"] wins
    generator_layout: str = "auto"
    # block rematerialization: None = auto (off on this card; the builder
    # logs where the JAX rule would turn it on); True / False force it
    remat: Optional[bool] = None

    # data (basic_conf.py:70-83)
    train_patch_size: Tuple[int, ...] = TRAIN_PATCH_SIZE
    val_patch_size: Tuple[int, ...] = VAL_PATCH_SIZE
    train_batch_size: Dict[int, int] = field(
        default_factory=lambda: {0: 6, -1: 3, 1: 3}
    )
    val_batch_size: Dict[int, int] = field(default_factory=lambda: {0: 2, -1: 2, 1: 2})
    num_workers: Tuple[int, int] = (4, 1)  # (train, val) prefetch threads
    prefetch_depth: int = 3
    dataset_paths: Tuple[str, ...] = ()
    # probability of a centerline-guided 3D TRAIN crop (patch window centered
    # on a random centerline point — BASELINE.json's "coronary-centerline-
    # guided 3D patch extraction"; 0.0 = the reference's uniform random crops)
    p_centerline_3d: float = 0.0

    # on-device spatial augmentation (basic_conf.py:88-113)
    augment: bool = True
    do_elastic: bool = True
    deformation_scale: Tuple[float, float] = (0.0, 0.25)
    p_elastic: float = 0.1
    do_scale: bool = True
    scale_range: Tuple[float, float] = (0.7, 1.4)
    p_scale: float = 0.2
    do_rotation: bool = True
    rotation_deg: float = 30.0
    p_rotation: float = 0.2

    # spatial augmentation executor: "host" = the loaders' worker threads
    # (data/host_augment.py); "device" = inside the train step
    # (StepConfig.augment)
    augment_backend: str = "host"

    # logging backend: wandb | tensorboard | file (JSONL scalars and PNG
    # grids) | console | none (experiments/builder.py)
    logger: str = "console"

    # schedule iterations per dispatch: None = auto (the builder's
    # resolve_cycle_length: train_generator_every where every cadence
    # divides it), 1 = per-iteration; K > 1 runs K iterations as one cycle,
    # a replayed CUDA graph on the card
    cycle_length: Optional[int] = None

    # data-parallel devices and spatial partitioning: not ported (the
    # builder raises when either is set)
    dp_devices: Optional[int] = None
    sp_devices: Optional[int] = None


# ---------------------------------------------------------------------------
# presets mirroring the reference experiment files
# ---------------------------------------------------------------------------


def basic_3d() -> ExperimentConfig:
    return ExperimentConfig()


def gradient_penalty() -> ExperimentConfig:
    """gradient_penalty_conf.py: WGAN-GP, Adam betas (0, 0.9), lr 1e-4,
    unnormalized critic."""
    cfg = basic_3d()
    return replace(
        cfg,
        name="gradient_penalty",
        weight_clip=None,
        betas=(0.0, 0.9),
        lr=1e-4,
        gp_weight=10.0,
        critic_args={**cfg.critic_args, "norm": None},
    )


def small_patch() -> ExperimentConfig:
    """small_patch_size.py: (128, 128, 32) patches, batches 40/20/20."""
    return replace(
        basic_3d(),
        name="small_patch",
        train_patch_size=(128, 128, 32),
        train_batch_size={0: 40, -1: 20, 1: 20},
    )


def gp_layernorm() -> ExperimentConfig:
    """gp_layernorm.py: GP + LayerNorm critic on small patches, no val."""
    cfg = gradient_penalty()
    return replace(
        cfg,
        name="gp_layernorm",
        train_patch_size=(128, 128, 32),
        train_batch_size={0: 40, -1: 20, 1: 20},
        validate_every=None,
        num_workers=(3, 1),
        critic_args={**cfg.critic_args, "norm": "layer"},
    )


def rmsprop() -> ExperimentConfig:
    """rmsprop_conf.py: RMSprop at basic lr on small patches."""
    return replace(small_patch(), name="rmsprop", optimizer="rmsprop", lr=2e-4)


def train_generator_more() -> ExperimentConfig:
    """train_generator_more_3D.py: GP mode with G every 1, D every 5."""
    return replace(
        gradient_penalty(),
        name="train_generator_more",
        train_critic_every=5,
        train_generator_every=1,
    )


def conf_2d() -> ExperimentConfig:
    """conf_2D.py: full 2D stack — 128^2 train / 512^2 val patches,
    batches 256/128/128, 6 resnet blocks, 16-ch critic, mirror + 360deg
    rotation augmentation only."""
    cfg = basic_3d()
    return replace(
        cfg,
        name="conf_2d",
        is_2d=True,
        train_patch_size=(128, 128),
        val_patch_size=(512, 512),
        train_batch_size={0: 256, -1: 128, 1: 128},
        val_batch_size={0: 256, -1: 128, 1: 128},
        generator_args={**cfg.generator_args, "n_resnet_blocks": 6, "ndim": 2},
        critic_args={**cfg.critic_args, "init_channels_out": 16, "ndim": 2},
        do_elastic=False,
        do_scale=False,
        do_rotation=True,
        rotation_deg=360.0,
        p_rotation=0.5,
    )


def gradient_penalty_2d() -> ExperimentConfig:
    """gradient_penalty_conf_2D.py: the 2D family with the WGAN-GP
    hyperparameters. The reference composes this by shared-dict mutation
    (conf_2D's star-import and gradient_penalty_conf both mutate
    basic_conf's ``critic_args`` in place), which nets out to the 2D 16-ch
    critic with the Identity norm — expressed here directly."""
    cfg = conf_2d()
    return replace(
        cfg,
        name="gradient_penalty_2d",
        weight_clip=None,
        betas=(0.0, 0.9),
        lr=1e-4,
        gp_weight=10.0,
        critic_args={**cfg.critic_args, "norm": None},
    )


def test_conf() -> ExperimentConfig:
    """test_conf.py: 61-iteration smoke run with frequent everything."""
    return replace(
        basic_3d(),
        name="test_conf",
        train_iterations=61,
        validate_every=10,
        checkpoint_every=20,
        log_every=10,
        log_images_every=15,
    )


def test_conf_2d() -> ExperimentConfig:
    return replace(
        conf_2d(),
        name="test_conf_2d",
        train_iterations=61,
        validate_every=10,
        checkpoint_every=20,
        log_every=10,
        log_images_every=15,
    )


PRESETS: Dict[str, Callable[[], ExperimentConfig]] = {
    "basic_3d": basic_3d,
    "gradient_penalty": gradient_penalty,
    "gp_layernorm": gp_layernorm,
    "rmsprop": rmsprop,
    "small_patch": small_patch,
    "train_generator_more": train_generator_more,
    "conf_2d": conf_2d,
    "gradient_penalty_2d": gradient_penalty_2d,
    "test_conf": test_conf,
    "test_conf_2d": test_conf_2d,
}


def load_config(spec: Optional[str], **overrides) -> ExperimentConfig:
    """Resolve a config: preset name, or a python file defining
    ``config(base) -> ExperimentConfig`` (composition, reference override
    semantics) or a module-level ``CONFIG``. Extra ``overrides`` are applied
    last with ``dataclasses.replace``."""
    if spec is None:
        cfg = basic_3d()
    elif spec in PRESETS:
        cfg = PRESETS[spec]()
    else:
        path = Path(spec)
        if not path.exists():
            raise ValueError(f"Unknown preset / missing file: {spec!r}")
        module_spec = importlib.util.spec_from_file_location(path.stem, path)
        module = importlib.util.module_from_spec(module_spec)
        module_spec.loader.exec_module(module)
        if hasattr(module, "config"):
            cfg = module.config(basic_3d())
        elif hasattr(module, "CONFIG"):
            cfg = module.CONFIG
        else:
            raise ValueError(f"{spec}: define config(base) or CONFIG")
    if overrides:
        cfg = replace(cfg, **overrides)
    return cfg


def asdict_flat(cfg: ExperimentConfig) -> Dict[str, Any]:
    """JSON-serializable dict for experiment tracking (reference
    ``config_from_globals`` whitelist, trainer/utils.py:126-166)."""
    out = {}
    for f_ in dataclasses.fields(cfg):
        v = getattr(cfg, f_.name)
        if isinstance(v, dict):
            out[f_.name] = {str(k): vv for k, vv in v.items()}
        elif isinstance(v, tuple):
            out[f_.name] = list(v)
        else:
            out[f_.name] = v
    return out
