"""Experiment logging (counterpart of ``contrast_gan_3d_tpu/trainer/
logger.py``): ``LoggerInterface`` with scalar and image hooks; the no-op
and console loggers; ``FileLogger`` (``scalars.jsonl`` and PNG grids), the
TensorBoard logger (``tensorboardX``) and the wandb logger, each with a 2D
variant that renders the batch as one slice grid; and
``MultiThreadedLogger``, which renders image events on a thread of their
own, one at a time, joined at ``end_hook``.

An image event renders one random sample's axial slices (the scaled
sample, the reconstruction and the RdBu attenuation map) with
``utils/visualization``, which needs matplotlib. Where matplotlib cannot be
imported (the card's machine has none), a logger built to take images logs
one warning naming it and takes scalars only (``logs_images`` False), so
the trainer computes no image batch for it; the JAX logger would compute
one at every image event and fail to render it on its thread.
"""

import importlib.util
import json
import logging
import math
import os
import threading
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

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


def _can_render(owner: str) -> bool:
    """Whether matplotlib can be imported; where it cannot, one warning."""
    if importlib.util.find_spec("matplotlib") is not None:
        return True
    logger.warning("%s: matplotlib is not installed, so no images are logged (scalars only)", owner)
    return False


def _render_sample_figs(scaler, sample, reconstruction, attenuation, masks, names, step, stage, max_slices, rng):
    """Yield (tag, figure) for ONE random sample's axial-slice grids: the
    sample's index is drawn first, from ``rng``. The caller closes them."""
    from contrast_gan_3d_tpu_torch.utils import visualization as viz

    idx = int(rng.integers(0, len(sample)))
    # names may be shorter than the batch (a loader without names)
    name = names[idx] if names and idx < len(names) else str(idx)
    mask = np.asarray(masks[idx]).squeeze() if masks is not None else None
    for tag, batch in (("sample", sample), ("reconstruction", reconstruction), ("attenuation", attenuation)):
        if batch is None:
            continue
        vol = np.asarray(batch[idx]).squeeze()
        is_atten = tag == "attenuation"
        img = vol if is_atten else np.asarray(scaler.unscale(vol))
        fig = viz.plot_axial_slices(
            img,
            mask=None if is_atten else mask,
            cmap="RdBu" if is_atten else "gray",
            max_slices=max_slices,
            title=f"{stage}/{tag} {name} @ {step}",
        )
        yield tag, fig


def _render_batch_figs(scaler, sample, reconstruction, attenuation, step, stage, max_slices, rng):
    """The 2D variant: the batch axis is the slice axis, so the batch
    renders as one grid, its slices drawn from ``rng``."""
    from contrast_gan_3d_tpu_torch.utils import visualization as viz

    for tag, batch in (("sample", sample), ("reconstruction", reconstruction), ("attenuation", attenuation)):
        if batch is None:
            continue
        imgs = np.asarray(batch)  # (B, W, H[, 1])
        if imgs.ndim == 4:
            imgs = imgs[..., 0]
        # not squeeze(): a batch of one would lose its batch axis, and the
        # moveaxis would transpose the lone slice
        is_atten = tag == "attenuation"
        vol = np.moveaxis(imgs, 0, -1)
        img = vol if is_atten else np.asarray(scaler.unscale(vol))
        fig = viz.plot_axial_slices(
            img,
            cmap="RdBu" if is_atten else "gray",
            max_slices=max_slices,
            title=f"{stage}/{tag} @ {step}",
            rng=rng,
        )
        yield tag, fig


class _ImageLogger(LoggerInterface):
    """What the wandb, file and TensorBoard loggers share: their figures,
    from ``scaler``, ``max_slices`` and ``rng``. ``batch_is_slices`` (the
    2D variants): the batch renders as one slice grid."""

    batch_is_slices = False

    def _figs(self, sample, reconstruction, attenuation, masks, names, step, stage):
        if self.batch_is_slices:
            return _render_batch_figs(self.scaler, sample, reconstruction, attenuation, step, stage,
                                      self.max_slices, self.rng)
        return _render_sample_figs(self.scaler, sample, reconstruction, attenuation, masks, names, step, stage,
                                   self.max_slices, self.rng)


def has_wandb() -> bool:
    """Whether wandb imports (the JAX module's ``HAS_WANDB``)."""
    try:
        import wandb  # noqa: F401
    except Exception:  # what the JAX logger module catches
        return False
    return True


class WandbLogger(_ImageLogger):
    """wandb scalars against an ``iteration`` step metric, and the
    axial-slice grids as ``wandb.Image``. An explicit ``run`` wins;
    otherwise the active run is looked up at each call (``wandb.init`` may
    come after the logger), and with none the logger warns once and drops
    what it is given."""

    def __init__(self, scaler, run=None, max_slices: int = 64, rng: Optional[np.random.Generator] = None):
        if not has_wandb():
            raise ImportError("wandb is not installed; use ConsoleLogger/NoopLogger")
        import wandb

        self._wandb = wandb
        self.scaler = scaler
        self._run = run
        self.max_slices = max_slices
        self.rng = rng or np.random.default_rng()
        self.logs_images = _can_render(type(self).__name__)
        self._metrics_defined = False
        self._warned_no_run = False
        if self.run is not None:
            self._define_metrics()

    @property
    def run(self):
        return self._run if self._run is not None else self._wandb.run

    def _define_metrics(self):
        # a resumed run keeps a monotonic x axis
        self.run.define_metric("iteration")
        self.run.define_metric("*", step_metric="iteration")
        self._metrics_defined = True

    def _resolve_run(self):
        """The run to log into, or None (and one warning): a tracker that
        failed to start must not stop the training run."""
        run = self.run
        if run is None:
            if not self._warned_no_run:
                self._warned_no_run = True
                logger.warning("WandbLogger has no active run (wandb.init failed or was never called) — "
                               "dropping metrics")
            return None
        if not self._metrics_defined:
            self._define_metrics()
        return run

    def log_scalars(self, scalars, step, stage="train"):
        run = self._resolve_run()
        if run is None:
            return
        run.log({f"{stage}/{k}": float(v) for k, v in scalars.items()} | {"iteration": step})

    def log_images(self, sample, reconstruction, attenuation, masks, names, step, stage="train"):
        from contrast_gan_3d_tpu_torch.utils import visualization as viz

        run = self._resolve_run()
        if run is None:
            return
        payload = {"iteration": step}
        for tag, fig in self._figs(sample, reconstruction, attenuation, masks, names, step, stage):
            payload[f"{stage}/{tag}"] = self._wandb.Image(fig)
            viz.close(fig)
        run.log(payload)


class WandbLogger2D(WandbLogger):
    """The 2D variant: the batch renders as one slice grid."""

    batch_is_slices = True


class FileLogger(_ImageLogger):
    """Scalars appended to ``<out_dir>/scalars.jsonl``, one JSON object
    (stage, iteration, values; a non-finite value as null) per call, so a
    resumed run continues the stream; image grids as PNGs under
    ``<out_dir>/images/`` (``{stage}_{tag}_{step:08d}.png``, dpi 100)."""

    def __init__(self, scaler, out_dir, max_slices: int = 64, rng: Optional[np.random.Generator] = None,
                 save_images: bool = True):
        self.scaler = scaler
        self.out_dir = Path(out_dir)
        self.max_slices = max_slices
        self.rng = rng or np.random.default_rng()
        self.save_images = save_images
        # the trainer computes no image batch for a logger that drops it
        self.logs_images = save_images and _can_render(type(self).__name__)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self._scalar_path = self.out_dir / "scalars.jsonl"
        self._lock = threading.Lock()  # image threads may interleave

    def log_scalars(self, scalars, step, stage="train"):
        rec = {"stage": stage, "iteration": int(step)}
        # NaN and Infinity are no JSON tokens: a diverged loss is null
        rec.update({k: (v if math.isfinite(v) else None) for k, v in ((k, float(v)) for k, v in scalars.items())})
        line = json.dumps(rec, allow_nan=False) + "\n"
        with self._lock, open(self._scalar_path, "a") as fh:
            fh.write(line)

    def log_images(self, sample, reconstruction, attenuation, masks, names, step, stage="train"):
        if not self.save_images:
            return
        from contrast_gan_3d_tpu_torch.utils import visualization as viz

        img_dir = self.out_dir / "images"
        img_dir.mkdir(parents=True, exist_ok=True)
        for tag, fig in self._figs(sample, reconstruction, attenuation, masks, names, step, stage):
            fig.savefig(img_dir / f"{stage}_{tag}_{int(step):08d}.png", dpi=100)
            viz.close(fig)


class FileLogger2D(FileLogger):
    """The 2D variant: the batch renders as one slice grid."""

    batch_is_slices = True


class TensorBoardLogger(_ImageLogger):
    """TensorBoard event files through ``tensorboardX.SummaryWriter``:
    scalars as ``<stage>/<key>`` curves, the axial-slice grids as image
    summaries. A resumed run appends a new event file in the same
    directory; readers merge them on the step axis."""

    _SEQ = 0  # writers made in this process (see filename_suffix)

    def __init__(self, scaler, out_dir, max_slices: int = 64, rng: Optional[np.random.Generator] = None):
        from tensorboardX import SummaryWriter

        self.scaler = scaler
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        # tensorboardX names a file by its second and host only: two writers
        # in one directory within a second would overwrite each other
        TensorBoardLogger._SEQ += 1
        self.writer = SummaryWriter(logdir=str(self.out_dir),
                                    filename_suffix=f".{os.getpid()}.{TensorBoardLogger._SEQ}")
        self.max_slices = max_slices
        self.rng = rng or np.random.default_rng()
        self.logs_images = _can_render(type(self).__name__)
        self._lock = threading.Lock()  # image threads may interleave

    def log_scalars(self, scalars, step, stage="train"):
        with self._lock:
            for k, v in scalars.items():
                self.writer.add_scalar(f"{stage}/{k}", float(v), int(step))
            self.writer.flush()

    def log_images(self, sample, reconstruction, attenuation, masks, names, step, stage="train"):
        from contrast_gan_3d_tpu_torch.utils import visualization as viz

        for tag, fig in self._figs(sample, reconstruction, attenuation, masks, names, step, stage):
            with self._lock:
                self.writer.add_figure(f"{stage}/{tag}", fig, int(step), close=False)
            viz.close(fig)
        with self._lock:
            self.writer.flush()

    def end_hook(self):
        with self._lock:
            self.writer.close()


class TensorBoardLogger2D(TensorBoardLogger):
    """The 2D variant: the batch renders as one slice grid."""

    batch_is_slices = True


class MultiThreadedLogger(LoggerInterface):
    """Wraps a logger: scalars go through at once, each image event renders
    on a daemon thread of its own (``log-images-<stage>-<step>``), one at a
    time (pyplot and the logger's rng are not thread safe). ``end_hook``
    joins them, 60 s each, then the inner logger's."""

    def __init__(self, inner: LoggerInterface):
        self.inner = inner
        self._threads: List[threading.Thread] = []
        self._render_lock = threading.Lock()

    @property
    def logs_images(self) -> bool:
        return self.inner.logs_images

    def log_scalars(self, scalars, step, stage="train"):
        self.inner.log_scalars(scalars, step, stage)

    def log_images(self, sample, reconstruction, attenuation, masks, names, step, stage="train"):
        args = tuple(np.asarray(a) if a is not None and not isinstance(a, list) else a
                     for a in (sample, reconstruction, attenuation, masks))

        def _render():
            with self._render_lock:
                self.inner.log_images(*args, names, step, stage)

        t = threading.Thread(target=_render, name=f"log-images-{stage}-{step}", daemon=True)
        t.start()
        # end_hook runs once per fit: drop the finished threads as we go
        self._threads = [x for x in self._threads if x.is_alive()]
        self._threads.append(t)

    def end_hook(self):
        for t in self._threads:
            t.join(timeout=60)
        self._threads = []
        self.inner.end_hook()
