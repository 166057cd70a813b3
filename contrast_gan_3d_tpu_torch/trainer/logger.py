"""Experiment logging (counterpart of ``contrast_gan_3d_tpu/trainer/
logger.py``): ``LoggerInterface`` with scalar and image hooks, the no-op
and console loggers, and ``FileLogger`` for scalars
(``<out_dir>/scalars.jsonl``), of 2D runs too. Image files need matplotlib
and the wandb and TensorBoard backends their packages, none of which the
card's machine has: they are not ported (ROADMAP). Where wandb cannot be
imported, the builder logs to the console instead, as the JAX builder
does."""

import json
import logging
import math
import threading
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from contrast_gan_3d_tpu_torch.ops.block_conv import ROADMAP_NOTE

logger = logging.getLogger(__name__)



class LoggerInterface:
    """Scalars go out at once; images only where ``logs_images`` (the
    trainer checks it before it computes an image batch)."""

    logs_images: bool = True

    def log_scalars(self, scalars: Dict[str, float], step: int, stage: str = "train"):
        raise NotImplementedError

    def log_images(self, sample: np.ndarray, reconstruction: Optional[np.ndarray],
                   attenuation: Optional[np.ndarray], masks: Optional[np.ndarray],
                   names: Optional[List[str]], step: int, stage: str = "train"):
        raise NotImplementedError

    def end_hook(self):
        """Flush any pending work."""


class NoopLogger(LoggerInterface):
    logs_images = False

    def log_scalars(self, scalars, step, stage="train"):
        pass

    def log_images(self, *args, **kwargs):
        pass


class ConsoleLogger(LoggerInterface):
    """Scalars to this module's logger, ``[stage step] key=value ...``."""

    logs_images = False

    def log_scalars(self, scalars, step, stage="train"):
        msg = " ".join(f"{k}={float(v):.4f}" for k, v in scalars.items())
        logger.info("[%s %d] %s", stage, step, msg)

    def log_images(self, *args, **kwargs):
        pass


class FileLogger(LoggerInterface):
    """Scalars appended to ``<out_dir>/scalars.jsonl``, one JSON object
    (stage, iteration, values; a non-finite value as null) per call. The
    JAX FileLogger's image files (matplotlib) are not ported."""

    logs_images = False

    def __init__(self, out_dir):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self._scalar_path = self.out_dir / "scalars.jsonl"
        self._lock = threading.Lock()

    def log_scalars(self, scalars, step, stage="train"):
        rec = {"stage": stage, "iteration": int(step)}
        rec.update({k: (v if math.isfinite(v) else None) for k, v in ((k, float(v)) for k, v in scalars.items())})
        line = json.dumps(rec, allow_nan=False) + "\n"
        with self._lock, open(self._scalar_path, "a") as fh:
            fh.write(line)

    def log_images(self, *args, **kwargs):
        pass


def has_wandb() -> bool:
    """Whether wandb imports (the JAX module's ``HAS_WANDB``)."""
    try:
        import wandb  # noqa: F401
    except Exception:  # what the JAX logger module catches
        return False
    return True


class WandbLogger(LoggerInterface):
    """Without wandb it raises ImportError, as the JAX logger does (the
    builder takes ``ConsoleLogger`` then); with it, the logger is not
    ported."""

    def __init__(self, *args, **kwargs):
        if not has_wandb():
            raise ImportError("wandb is not installed; use ConsoleLogger/NoopLogger")
        raise NotImplementedError(f"the wandb logger is {ROADMAP_NOTE}")


class TensorBoardLogger(LoggerInterface):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"the TensorBoard logger is {ROADMAP_NOTE}")
