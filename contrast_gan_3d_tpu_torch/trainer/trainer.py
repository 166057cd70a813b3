"""The training loop around the steps (counterpart of
``contrast_gan_3d_tpu/trainer/trainer.py`` without meshes and fused
cycles): ``Trainer.train_step`` runs the branch the schedule makes due,
``Trainer.fit`` pulls batches from the loaders, trains, logs, validates,
checkpoints and resumes the model and the data streams.

The loop never waits on the card at a log point: the metrics of a log
boundary stay 0-d device tensors until the NEXT boundary, where the
previous window's are converted (the lagged fetch), and
``patches_per_sec`` is measured between those conversions. ``TimeBudget``
charges the loop's wall time to its phases.
"""

import itertools
import logging
import signal
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from contrast_gan_3d_tpu_torch.trainer import checkpoint as ckpt_lib
from contrast_gan_3d_tpu_torch.trainer.logger import LoggerInterface, NoopLogger
from contrast_gan_3d_tpu_torch.trainer.optim import ScheduledOptimizer
from contrast_gan_3d_tpu_torch.trainer.steps import (
    StepConfig,
    build_preview_step,
    build_train_steps,
    build_val_steps,
    init_state,
)
from contrast_gan_3d_tpu_torch.utils.signals import install_graceful_stop

logger = logging.getLogger(__name__)

# the keys of a patches dict: the JAX package's ScanType values
OPT, LOW, HIGH = 0, -1, 1
SCAN_TYPES = (OPT, LOW, HIGH)


@dataclass
class TrainerConfig:
    """Schedule and cadences (reference ``basic_conf.py:22-30``)."""

    train_iterations: int = 10_000
    train_critic_every: Optional[int] = 1
    train_generator_every: Optional[int] = 5
    val_every: Optional[int] = 400
    val_iterations: int = 2
    log_every: Optional[int] = 100
    log_images_every: Optional[int] = 500
    checkpoint_every: Optional[int] = 1000
    checkpoint_keep: Optional[int] = None
    checkpoint_dir: Optional[str] = None


def _due(iteration: int, every: Optional[int], skip_zero: bool = True) -> bool:
    if every is None or (skip_zero and iteration == 0):
        return False
    return iteration % every == 0


class TimeBudget:
    """Wall-clock seconds of the train loop by phase: each ``mark(phase)``
    charges the time since the previous mark. Window seconds go out with
    every log boundary as ``tb/<phase>_s``."""

    PHASES = ("data_wait", "dispatch", "sync_log", "images", "validation", "checkpoint", "other")

    def __init__(self):
        self.total: Dict[str, float] = {p: 0.0 for p in self.PHASES}
        self._window: Dict[str, float] = {p: 0.0 for p in self.PHASES}
        self._t = time.perf_counter()

    def mark(self, phase: str):
        now = time.perf_counter()
        dt, self._t = now - self._t, now
        self.total[phase] += dt
        self._window[phase] += dt

    def window_scalars(self) -> Dict[str, float]:
        out = {f"tb/{k}_s": round(v, 4) for k, v in self._window.items() if v}
        self._window = {p: 0.0 for p in self.PHASES}
        return out

    def shares(self) -> Dict[str, float]:
        tot = sum(self.total.values()) or 1e-9
        return {k: v / tot for k, v in self.total.items()}

    def summary(self) -> str:
        tot = sum(self.total.values()) or 1e-9
        parts = [f"{k} {v:.1f}s ({100 * v / tot:.1f}%)"
                 for k, v in sorted(self.total.items(), key=lambda kv: -kv[1]) if v > 0.005]
        return f"time budget over {tot:.1f}s: " + ", ".join(parts)


class Trainer:
    """Owns the train state and steps. ``train_step(patches, iteration)``
    runs the branch that the schedule (critic every ``train_critic_every``,
    generator every ``train_generator_every`` iterations, iteration 0
    included) makes due; ``fit`` runs the whole loop. With a
    ``checkpoint_dir`` the state resumes from its latest checkpoint."""

    def __init__(
        self,
        generator: nn.Module,
        critic: nn.Module,
        gen_tx: Callable[..., ScheduledOptimizer],
        critic_tx: Callable[..., ScheduledOptimizer],
        step_config: Optional[StepConfig] = None,
        trainer_config: Optional[TrainerConfig] = None,
        *,
        seed: int = 0,
        logger_interface: Optional[LoggerInterface] = None,
        device="cuda",
    ):
        self.cfg = trainer_config or TrainerConfig()
        self.step_cfg = step_config or StepConfig()
        self.logger_interface = logger_interface or NoopLogger()
        # module semantics the state_dict cannot encode, for inference
        self._ckpt_meta = {"generator": {k: getattr(generator, k) for k in ("tconv_placement", "norm")
                                         if hasattr(generator, k)}}
        self._stop_event = threading.Event()
        self.state = init_state(generator, critic, gen_tx, critic_tx, seed=seed, device=device)
        if self.cfg.checkpoint_dir:
            self.state = ckpt_lib.maybe_restore(self.state, self.cfg.checkpoint_dir)
        self.steps = build_train_steps(self.step_cfg)
        self.val_opt_step, self.val_subopt_step = build_val_steps(self.step_cfg)
        # device-augmented batches: image logging re-derives the step's
        # augmentation, so the logged batch is the one it trained on
        self._preview_step = build_preview_step(self.step_cfg) if self.step_cfg.augment is not None else None
        self.time_budget: Optional[TimeBudget] = None

    @property
    def iteration(self) -> int:
        return int(self.state.step)

    def _assemble(self, patches: Dict[int, Dict]) -> tuple:
        """3-stream batches -> (opt, subopt, subopt_mask, names) on the
        state's device; the sub-optimal streams join in the order LOW, HIGH.
        Tensors the loaders already put on the device are used as they
        are; only host batches are copied."""
        dev = self.state.device
        low, high = patches[LOW], patches[HIGH]
        names = list(low.get("name", [])) + list(high.get("name", []))
        on_dev = lambda a: torch.as_tensor(a, device=dev)
        opt = on_dev(patches[OPT]["data"])
        subopt = torch.cat([on_dev(low["data"]), on_dev(high["data"])])
        mask = torch.cat([on_dev(low["seg"]), on_dev(high["seg"])])
        return opt, subopt, mask, names

    def train_step(self, patches: Dict[int, Dict], iteration: int):
        """One schedule-aware step; returns (metrics, (subopt, mask, names))."""
        opt, subopt, mask, names = self._assemble(patches)
        critic_due = _due(iteration, self.cfg.train_critic_every, skip_zero=False)
        gen_due = _due(iteration, self.cfg.train_generator_every, skip_zero=False)
        if critic_due and gen_due:
            self.state, metrics = self.steps.combined_step(self.state, opt, subopt, mask)
        elif critic_due:
            self.state, metrics = self.steps.critic_step(self.state, opt, subopt, mask)
        elif gen_due:
            self.state, metrics = self.steps.generator_only_step(self.state, opt, subopt, mask)
        else:
            # an iteration that trains neither network still advances the
            # step counter, so it stays aligned with the iteration count
            self.state.step += 1
            metrics = {}
        return metrics, (subopt, mask, names)

    # -- graceful stop --------------------------------------------------------
    def request_stop(self, reason: str = "") -> None:
        """Ask :meth:`fit` to stop at the next iteration boundary (signal-
        and thread-safe); it then writes the final checkpoint and data
        sidecar as at a normal end."""
        if not self._stop_event.is_set():
            will_checkpoint = self.cfg.checkpoint_dir and self.cfg.checkpoint_every is not None
            logger.warning("Graceful stop requested%s — finishing the current iteration, then %s",
                           f" ({reason})" if reason else "",
                           "checkpointing and exiting" if will_checkpoint
                           else "exiting WITHOUT a checkpoint (checkpointing is disabled)")
            self._stop_event.set()

    @property
    def stop_requested(self) -> bool:
        return self._stop_event.is_set()

    # -- the loop ---------------------------------------------------------------
    def _flush_oldest_log(self):
        """Convert and emit the oldest pending log boundary. Its work is a
        window old, so the conversion does not stall the queue;
        ``patches_per_sec`` spans two conversions."""
        e = self._pending_logs.pop(0)
        host = {k: float(v) for k, v in e["metrics"].items()}
        now = time.perf_counter()
        last_it, last_t = self._last_fetch
        if e["iteration"] > last_it and last_t is not None:
            host["patches_per_sec"] = (e["iteration"] - last_it) * e["n_patches"] / max(now - last_t, 1e-9)
        self._last_fetch = (e["iteration"], now)
        host.update(e["tb"])
        self.logger_interface.log_scalars(host, e["iteration"], "train")

    def fit(self, train_loaders: Dict[int, Iterable], val_loaders: Optional[Dict[int, Iterable]] = None):
        """Train from the state's step to ``train_iterations``; returns the
        state."""
        start = self.start_iteration = self.iteration
        if start and self.cfg.checkpoint_dir:
            self._data_state(train_loaders, "restore", start)
        self._manage_loaders(train_loaders, "start")
        if val_loaders and self.cfg.val_every:
            self._manage_loaders(val_loaders, "start")
        logger.info("Training from iteration %d to %d", start, self.cfg.train_iterations)
        self._pending_logs = []
        self._last_fetch = (start, None)
        budget = self.time_budget = TimeBudget()
        checkpointing = bool(self.cfg.checkpoint_dir) and self.cfg.checkpoint_every is not None
        iteration = start
        while iteration < self.cfg.train_iterations:
            budget.mark("other")
            if self.stop_requested:
                logger.warning("Stopping at iteration %d (graceful stop)%s", iteration,
                               "" if checkpointing else f"; checkpointing is disabled, so progress since "
                                                        f"iteration {start} is discarded")
                break
            patches = {st: next(train_loaders[st]) for st in SCAN_TYPES}
            budget.mark("data_wait")
            images_due = (_due(iteration, self.cfg.log_images_every, skip_zero=False)
                          and self.logger_interface.logs_images)
            # the step advances state.rng: keep its state so the preview can
            # re-derive this step's augmentation
            rng_before = self.state.rng.get_state() if images_due and self._preview_step else None
            metrics, (subopt, mask, names) = self.train_step(patches, iteration)
            budget.mark("dispatch")
            if metrics and _due(iteration, self.cfg.log_every, skip_zero=False):
                self._pending_logs.append({
                    "iteration": iteration,
                    "metrics": metrics,
                    "n_patches": sum(p["data"].shape[0] for p in patches.values()),
                    "tb": budget.window_scalars(),
                })
                while len(self._pending_logs) > 1:
                    self._flush_oldest_log()
                budget.mark("sync_log")
            if images_due and metrics:
                self._log_train_images(subopt, mask, names, iteration, rng_before)
                budget.mark("images")
            if val_loaders and _due(iteration, self.cfg.val_every):
                self.validate(val_loaders, iteration)
                budget.mark("validation")
            if checkpointing and _due(iteration, self.cfg.checkpoint_every):
                ckpt_lib.save_checkpoint(self.state, self.cfg.checkpoint_dir, keep=self.cfg.checkpoint_keep,
                                         async_=True, meta=self._ckpt_meta)
                self._data_state(train_loaders, "save", self.iteration)
                budget.mark("checkpoint")
            iteration += 1

        budget.mark("other")
        while self._pending_logs:
            self._flush_oldest_log()
        budget.mark("sync_log")
        logger.info(budget.summary())
        if checkpointing:
            ckpt_lib.save_checkpoint(self.state, self.cfg.checkpoint_dir, keep=self.cfg.checkpoint_keep,
                                     meta=self._ckpt_meta)
            self._data_state(train_loaders, "save", self.iteration)
            budget.mark("checkpoint")
        self._manage_loaders(train_loaders, "end")
        if val_loaders:
            self._manage_loaders(val_loaders, "end")
        self.logger_interface.end_hook()
        return self.state

    def validate(self, val_loaders: Dict[int, Iterable], train_iteration: int):
        """Eval-mode sweep (reference Trainer.py:247-308): OPT batches score
        the critic, sub-optimal batches run the generator; the first
        sub-optimal batches are logged as images where the logger takes
        them. The scalars keep the reference's normalisation."""
        loss_sim = loss_G = loss_real_C = loss_fake_C = 0.0
        loggable = []
        collect_images = self.cfg.log_images_every is not None and self.logger_interface.logs_images
        n_subopt = self.cfg.val_iterations * (len(SCAN_TYPES) - 1)
        dev = self.state.device
        for i, st in itertools.product(range(self.cfg.val_iterations), SCAN_TYPES):
            batch = next(val_loaders[st])
            data = torch.as_tensor(batch["data"], device=dev)
            w = torch.ones((data.shape[0],), device=dev)
            if st == OPT:
                loss_real_C -= float(self.val_opt_step(self.state, data, w))
            else:
                loss_fake, l_sim, sample_hat, atten = self.val_subopt_step(self.state, data, w)
                loss_fake = float(loss_fake)
                loss_fake_C += loss_fake
                loss_G -= loss_fake
                loss_sim += float(l_sim)
                if i == 0 and collect_images:
                    loggable.append((batch, data, sample_hat, atten))
        if loggable:
            host = lambda t: t.detach().float().cpu().numpy()
            self.logger_interface.log_images(
                np.concatenate([host(self.step_cfg.scaler(d.float())) for _, d, _, _ in loggable]),
                np.concatenate([host(r[:, 0]) for _, _, r, _ in loggable]),
                np.concatenate([host(a[:, 0]) for _, _, _, a in loggable]),
                np.concatenate([np.asarray(torch.as_tensor(b["seg"]).cpu()) for b, _, _, _ in loggable]),
                sum((list(b.get("name", [])) for b, _, _, _ in loggable), []),
                train_iteration, "validation",
            )
        self.logger_interface.log_scalars({
            "D": (loss_real_C + loss_fake_C) / self.cfg.val_iterations,
            "G": loss_G / n_subopt,
            "sim": loss_sim / n_subopt,
        }, train_iteration, "validation")

    def _log_train_images(self, subopt, mask, names, iteration: int, rng_before=None):
        """Render the batch the step trained on: with on-device augmentation
        the preview re-derives it from ``rng_before``; otherwise the batch
        arrived as it trained (host-augmented or not augmented)."""
        if self._preview_step is not None and rng_before is not None:
            sample, sample_hat, atten, mask = self._preview_step(self.state, rng_before, subopt, mask)
        else:
            w = torch.ones((subopt.shape[0],), device=self.state.device)
            _, _, sample_hat, atten = self.val_subopt_step(self.state, subopt, w)
            sample = self.step_cfg.scaler(subopt.float()).unsqueeze(1)
            mask = mask.unsqueeze(1)
        host = lambda t: t[:, 0].detach().float().cpu().numpy()
        self.logger_interface.log_images(host(sample), host(sample_hat), host(atten), host(mask), names,
                                         iteration, "train")

    def _data_state(self, loaders: Dict[int, Iterable], action: str, step: int):
        """Save or restore the loaders' stream states beside the model
        checkpoint (loaders without get_state/set_state are skipped)."""
        stateful = {k: v for k, v in loaders.items() if hasattr(v, "get_state") and hasattr(v, "set_state")}
        if not stateful:
            return
        if action == "save":
            ckpt_lib.save_data_state(stateful, self.cfg.checkpoint_dir, step)
        else:
            ckpt_lib.maybe_restore_data_state(stateful, self.cfg.checkpoint_dir, step)

    @staticmethod
    def _manage_loaders(loaders: Dict[int, Iterable], event: str):
        for loader in loaders.values():
            fn = getattr(loader, "start" if event == "start" else "stop", None)
            if fn is not None:
                fn()


def install_preemption_handler(trainer: Trainer, signums=(signal.SIGTERM, signal.SIGINT)):
    """SIGTERM / SIGINT -> :meth:`Trainer.request_stop`; a second delivery
    escalates (``utils/signals.install_graceful_stop``). Returns the
    previous handlers, or None off the main thread."""
    return install_graceful_stop(lambda name: trainer.request_stop(reason=name),
                                 lambda: trainer.stop_requested, signums)
