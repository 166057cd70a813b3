"""The training loop around the steps (counterpart of
``contrast_gan_3d_tpu/trainer/trainer.py``):
``Trainer.train_step`` runs the branch the schedule makes due,
``Trainer.train_step_cycle`` runs ``cycle_length`` iterations as one
``steps.CycleStep`` (one replayed CUDA graph per branch pattern on the
card, the per-iteration loop on the CPU), ``Trainer.fit`` pulls batches
from the loaders, trains, logs, validates, checkpoints and resumes the
model and the data streams.

The loop never waits on the card at a log point: the metrics of a log
boundary start copying to pinned host memory there (no wait; a replayed
graph overwrites its outputs at the next replay, after the copy), with an
event behind the copy, and are read at the NEXT boundary once that event
has passed (the lagged fetch): the wait covers the previous boundary's
work only, not the work dispatched since. ``patches_per_sec`` is measured
between those reads. ``TimeBudget`` charges the loop's wall time to its
phases.

Under a data-parallel mesh (``Trainer(mesh=...)``, one process per device,
``parallel/mesh.py``) every rank runs this loop in lockstep on the same
schedule: it loads its host's batches and trains on its share
(``_assemble``, which refuses batches the ranks do not divide, as JAX's
Trainer does), validates on its share of batches padded to the ranks,
stops where every rank stops (the stop flags are all-reduced every
``stop_sync_every`` iterations), and leaves the checkpoint, the logs and
each host's data sidecar to one rank.
"""

import itertools
import logging
import signal
import threading
import time
from dataclasses import dataclass
from dataclasses import replace as dc_replace
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch import nn

from contrast_gan_3d_tpu_torch.parallel.mesh import LOCAL, DataMesh, pad_batch_to_multiple
from contrast_gan_3d_tpu_torch.trainer import checkpoint as ckpt_lib
from contrast_gan_3d_tpu_torch.trainer.logger import LoggerInterface, NoopLogger
from contrast_gan_3d_tpu_torch.trainer.optim import ScheduledOptimizer
from contrast_gan_3d_tpu_torch.trainer.steps import (
    CycleStep,
    StepConfig,
    build_cycle_step,
    build_preview_step,
    build_train_steps,
    build_val_steps,
    graphed,
    init_state,
    schedule_branches,
)
from contrast_gan_3d_tpu_torch.utils.debug import check_finite
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
    # data-parallel runs agree on a graceful stop every N iterations (ranks
    # receive signals at different times); one process checks its flag at
    # every cycle boundary
    stop_sync_every: int = 10
    # schedule iterations per dispatch (fused schedule cycles): 1 dispatches
    # each iteration; K > 1 runs K iterations as one CycleStep
    cycle_length: int = 1


def _start_host_copy(metrics: Dict[str, torch.Tensor]):
    """(host tensors, event): a boundary's 0-d metrics copying to pinned
    host memory on the current stream, and an event recorded behind the
    copies (None on the CPU, where the tensors are cloned)."""
    if next(iter(metrics.values())).device.type != "cuda":
        return {k: v.detach().clone() for k, v in metrics.items()}, None
    host = {k: v.detach().to("cpu", non_blocking=True) for k, v in metrics.items()}
    event = torch.cuda.Event()
    event.record()
    return host, event


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
    included) makes due; ``fit`` runs the whole loop, in cycles of
    ``cycle_length`` iterations when it is above 1. With a
    ``checkpoint_dir`` the state resumes from its latest checkpoint.
    ``split_combined=True`` runs the combined branch as the two phases
    (``critic_phase``, ``generator_phase``) and forces ``cycle_length`` 1,
    as the JAX Trainer does. ``mesh``: this rank's ``DataMesh`` (data
    parallelism; its device is ``device``), or None for one device
    (``parallel/mesh.LOCAL``)."""

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
        split_combined: bool = False,
        mesh=None,
    ):
        trainer_config = trainer_config or TrainerConfig()
        if split_combined and trainer_config.cycle_length > 1:
            # a cycle runs the fused combined step, the program the split
            # mode exists to avoid: dispatch per iteration instead
            logger.warning("split_combined=True: cycle_length=%d ignored — fused schedule cycles run the combined "
                           "step the split mode avoids; dispatching per-iteration", trainer_config.cycle_length)
            trainer_config = dc_replace(trainer_config, cycle_length=1)
        self.cfg = trainer_config
        self.split_combined = split_combined
        self.step_cfg = step_config or StepConfig()
        self.mesh = mesh = mesh or LOCAL
        # rank 0 logs and checkpoints for every rank (their states are equal)
        self.is_writer = mesh.rank == 0
        self.logger_interface = (logger_interface if self.is_writer else None) or NoopLogger()
        # module semantics the state_dict cannot encode, for inference
        self._ckpt_meta = {"generator": {k: getattr(generator, k) for k in ("tconv_placement", "norm")
                                         if hasattr(generator, k)}}
        self._stop_event = threading.Event()
        self._warned_images = False
        self.state = init_state(generator, critic, gen_tx, critic_tx, seed=seed, device=device, mesh=mesh)
        if self.cfg.checkpoint_dir:
            self.state = ckpt_lib.maybe_restore(self.state, self.cfg.checkpoint_dir)
        self.steps = build_train_steps(self.step_cfg)
        # one CycleStep per branch pattern, built at its first use (a run
        # whose horizon K does not divide gets a shorter tail pattern); on
        # the card their captures share one memory pool and one stream
        self._cycle_cache: Dict[tuple, CycleStep] = {}
        self._graph_pool = self._capture_stream = None
        k = self.cfg.cycle_length
        if k > 1:
            off = [n for n, every in (("log_every", self.cfg.log_every),
                                      ("log_images_every", self.cfg.log_images_every),
                                      ("val_every", self.cfg.val_every),
                                      ("checkpoint_every", self.cfg.checkpoint_every),
                                      ("stop_sync_every", self.cfg.stop_sync_every))
                   if every is not None and every % k]
            if off:
                logger.warning("cycle_length=%d: cadence(s) %s are not multiples of the cycle — they fire only at "
                               "cycle boundaries that happen to divide them", k, ", ".join(off))
        self.val_opt_step, self.val_subopt_step = build_val_steps(self.step_cfg)
        # device-augmented batches: image logging re-derives the step's
        # augmentation, so the logged batch is the one it trained on
        self._preview_step = build_preview_step(self.step_cfg) if self.step_cfg.augment is not None else None
        self.time_budget: Optional[TimeBudget] = None

    @property
    def iteration(self) -> int:
        return int(self.state.step)

    @property
    def cycle_dispatch(self) -> str:
        """How a cycle runs: "graph" (a replayed CUDA graph, under an NCCL
        mesh with its all-reduces captured) or "eager" (the loop over the
        steps: on the CPU, and under gloo, whose collectives a graph
        cannot capture)."""
        return "graph" if graphed(self.state) else "eager"

    def _assemble(self, patches: Dict[int, Dict]) -> tuple:
        """3-stream batches -> (opt, subopt, subopt_mask, names) on the
        state's device; the sub-optimal streams join in the order LOW, HIGH.
        Tensors the loaders already put on the device are used as they
        are; only host batches are copied. The rank keeps its slice of the
        joined batches (``DataMesh.batch_slice``; one device keeps them
        whole), which the host's ranks must divide: a padded train batch
        would bias the losses and BatchNorm's statistics, so it raises
        instead. Under spatial partitioning the patches stay whole (the
        step keeps the rank's X-slab), and their first dim must divide the
        space axis, as JAX's Trainer requires."""
        dev = self.state.device
        low, high = patches[LOW], patches[HIGH]
        names = list(low.get("name", [])) + list(high.get("name", []))
        # this rank's slices, then to its device
        opt = torch.as_tensor(patches[OPT]["data"])
        subopt = torch.cat([torch.as_tensor(low["data"]), torch.as_tensor(high["data"])])
        mask = torch.cat([torch.as_tensor(low["seg"]), torch.as_tensor(high["seg"])])
        n = self.mesh.ranks_per_host
        if opt.shape[0] % n or subopt.shape[0] % n:
            raise ValueError(
                f"host-local train batch sizes (opt {opt.shape[0]}, subopt {subopt.shape[0]}) must be divisible by "
                f"the {n} data-parallel ranks on this host; round them up to multiples of {n} (train does this) or "
                f"pick dp_devices that divides them")
        sp = self.mesh.space
        if subopt.shape[1] % sp:
            raise ValueError(f"first patch dim ({subopt.shape[1]}) must be divisible by the mesh's {sp} "
                             f"spatial-partitioning devices")
        keep = self.mesh.batch_slice(subopt.shape[0])
        opt = opt[self.mesh.batch_slice(opt.shape[0])]
        return opt.to(dev), subopt[keep].to(dev), mask[keep].to(dev), names[keep]

    def train_step(self, patches: Dict[int, Dict], iteration: int):
        """One schedule-aware step; returns (metrics, (subopt, mask, names))."""
        opt, subopt, mask, names = self._assemble(patches)
        critic_due = _due(iteration, self.cfg.train_critic_every, skip_zero=False)
        gen_due = _due(iteration, self.cfg.train_generator_every, skip_zero=False)
        if critic_due and gen_due:
            if self.split_combined:
                self.state, m1, subopt_s, mask_s = self.steps.critic_phase(self.state, opt, subopt, mask)
                self.state, m2 = self.steps.generator_phase(self.state, subopt_s, mask_s)
                metrics = {**m1, **m2}
            else:
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

    def _cycle_pattern(self, iteration: int, length: int) -> tuple:
        """Branch pattern for iterations [iteration, iteration+length)."""
        return schedule_branches(self.cfg.train_critic_every, self.cfg.train_generator_every, iteration, length)

    def train_step_cycle(self, patches_list: List[Dict[int, Dict]], iteration: int, pattern: Optional[tuple] = None):
        """``len(patches_list)`` schedule iterations as ONE cycle
        (``steps.CycleStep``, cached per branch pattern): the batches stack
        on a leading cycle axis. Returns the cycle's metrics (on the card a
        replay's static outputs: clone to keep them) and the FIRST
        iteration's (subopt, mask, names), whose pre-cycle rng state is what
        the image preview re-derives."""
        assembled = [self._assemble(p) for p in patches_list]
        stacked = [torch.stack([a[i] for a in assembled]) for i in range(3)]
        if pattern is None:
            pattern = self._cycle_pattern(iteration, len(patches_list))
        cycle = self._cycle_cache.get(pattern)
        if cycle is None:
            if self._graph_pool is None and self.state.device.type == "cuda":
                self._graph_pool = torch.cuda.graph_pool_handle()
                self._capture_stream = torch.cuda.Stream(device=self.state.device)
            cycle = self._cycle_cache[pattern] = build_cycle_step(self.steps, pattern, pool=self._graph_pool,
                                                                  stream=self._capture_stream)
        self.state, metrics = cycle(self.state, *stacked)
        return dict(metrics), assembled[0][1:]

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

    def _stop_due(self, iteration: int) -> bool:
        """Whether :meth:`fit` stops at this boundary. One process reads its
        flag. Under a mesh of several ranks the decision is collective: the
        flags are all-reduced every ``stop_sync_every`` iterations (every
        rank runs the same iterations, so the syncs line up) and every rank
        stops at the same boundary, as the JAX Trainer's ``_stop_due``
        does."""
        if self.mesh.world_size == 1:
            return self.stop_requested
        if iteration % max(1, self.cfg.stop_sync_every):
            return False
        if self.mesh.any(self.stop_requested):
            self._stop_event.set()  # the ranks that saw no signal
            return True
        return False

    def _can_log_images(self) -> bool:
        """Image logging needs a logger that takes images; under a mesh of
        several ranks a rank holds only its share of each batch, so it is
        off (as under the JAX package's multi-process meshes)."""
        if not self.logger_interface.logs_images:
            return False
        if self.mesh.world_size > 1:
            if not self._warned_images:
                self._warned_images = True
                logger.warning("image logging is off under a data-parallel mesh of %d ranks (a rank holds only its "
                               "share of each batch); set log_images_every=None to silence this",
                               self.mesh.world_size)
            return False
        return True

    # -- the loop ---------------------------------------------------------------
    def _flush_oldest_log(self):
        """Convert and emit the oldest pending log boundary. Its work is a
        window old: waiting for its event does not stall the queue;
        ``patches_per_sec`` spans two conversions."""
        e = self._pending_logs.pop(0)
        if e["event"] is not None:
            e["event"].synchronize()
        host = {k: float(v) for k, v in e["metrics"].items()}
        now = time.perf_counter()
        last_it, last_t = self._last_fetch
        if e["iteration"] > last_it and last_t is not None:
            host["patches_per_sec"] = (e["iteration"] - last_it) * e["n_patches"] / max(now - last_t, 1e-9)
        self._last_fetch = (e["iteration"], now)
        host.update(e["tb"])
        self.logger_interface.log_scalars(host, e["iteration"], "train")

    def fit(self, train_loaders: Dict[int, Iterable], val_loaders: Optional[Dict[int, Iterable]] = None,
            profiler=None):
        """Train from the state's step to ``train_iterations``; returns the
        state. ``profiler``: a ``torch.profiler.profile`` (the train CLI's
        ``--profiler-*``), started here, stepped after every dispatch (a
        cycle is one step) and stopped at the end."""
        start = self.start_iteration = self.iteration
        if start and self.cfg.checkpoint_dir:
            self._data_state(train_loaders, "restore", start)
        self._manage_loaders(train_loaders, "start")
        if val_loaders and self.cfg.val_every:
            self._manage_loaders(val_loaders, "start")
        logger.info("Training from iteration %d to %d", start, self.cfg.train_iterations)
        if self.cfg.cycle_length > 1:
            logger.info("%d-iteration cycles run %s%s", self.cfg.cycle_length,
                        "as replayed CUDA graphs" if self.cycle_dispatch == "graph" else "eagerly",
                        "" if not isinstance(self.mesh, DataMesh) else f" ({self.mesh.world_size} ranks, "
                        f"{self.mesh.data_size} x {self.mesh.space} dp x sp, "
                        f"{'all-reduces captured' if self.mesh.capturable else 'gloo cannot be captured'})")
        self._pending_logs = []
        self._last_fetch = (start, None)
        budget = self.time_budget = TimeBudget()
        if profiler is not None:
            profiler.start()
        checkpointing = bool(self.cfg.checkpoint_dir) and self.cfg.checkpoint_every is not None
        # a data-parallel host loads 1/hosts of each global batch
        hosts = self.mesh.hosts
        K = max(1, int(self.cfg.cycle_length))
        iteration = start
        while iteration < self.cfg.train_iterations:
            # cycle boundaries stay on multiples of K whatever the resume
            # point: a run resumed mid-cycle gets one short first cycle (else
            # later boundaries would miss the %-based cadences); the
            # horizon's tail is short too
            k_len = min(K - iteration % K, self.cfg.train_iterations - iteration)
            budget.mark("other")
            if self._stop_due(iteration):
                logger.warning("Stopping at iteration %d (graceful stop)%s", iteration,
                               "" if checkpointing else f"; checkpointing is disabled, so progress since "
                                                        f"iteration {start} is discarded")
                break
            if K == 1:
                patches = {st: next(train_loaders[st]) for st in SCAN_TYPES}
                pattern = None
            else:
                pattern = self._cycle_pattern(iteration, k_len)
                patches_list = [{st: next(train_loaders[st]) for st in SCAN_TYPES} for _ in range(k_len)]
                patches = patches_list[0]  # the per-iteration batch sizes
            budget.mark("data_wait")
            images_due = _due(iteration, self.cfg.log_images_every, skip_zero=False) and self._can_log_images()
            if images_due and pattern is not None:
                # the preview pairs the cycle's FIRST batch with the
                # pre-cycle rng; a "none" first branch never draws from it,
                # so the preview would show augmentation the batch never got
                images_due = pattern[0] != "none"
            # the step advances state.rng: keep its state so the preview can
            # re-derive this step's augmentation (in a cycle, its first's)
            rng_before = self.state.rng.get_state() if images_due and self._preview_step else None
            if K == 1:
                metrics, (subopt, mask, names) = self.train_step(patches, iteration)
            else:
                metrics, (subopt, mask, names) = self.train_step_cycle(patches_list, iteration, pattern)
            budget.mark("dispatch")
            if metrics and torch.is_anomaly_enabled():
                # --debug (utils/debug): the losses' own check, a host sync
                check_finite(metrics, iteration)
            if metrics and _due(iteration, self.cfg.log_every, skip_zero=False):
                host, event = _start_host_copy(metrics)
                self._pending_logs.append({
                    "iteration": iteration,
                    "metrics": host,
                    "event": event,
                    "n_patches": hosts * sum(p["data"].shape[0] for p in patches.values()),
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
                if self.is_writer:
                    ckpt_lib.save_checkpoint(self.state, self.cfg.checkpoint_dir, keep=self.cfg.checkpoint_keep,
                                             async_=True, meta=self._ckpt_meta)
                self._data_state(train_loaders, "save", self.iteration)
                budget.mark("checkpoint")
            if profiler is not None:
                profiler.step()
            iteration += k_len

        budget.mark("other")
        if profiler is not None:
            profiler.stop()
        while self._pending_logs:
            self._flush_oldest_log()
        budget.mark("sync_log")
        logger.info(budget.summary())
        if checkpointing:
            if self.is_writer:
                ckpt_lib.save_checkpoint(self.state, self.cfg.checkpoint_dir, keep=self.cfg.checkpoint_keep,
                                         meta=self._ckpt_meta)
            self._data_state(train_loaders, "save", self.iteration)
            self.mesh.barrier()  # the checkpoint is on disk before any rank returns
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
        collect_images = self.cfg.log_images_every is not None and self._can_log_images()
        n_subopt = self.cfg.val_iterations * (len(SCAN_TYPES) - 1)
        for i, st in itertools.product(range(self.cfg.val_iterations), SCAN_TYPES):
            batch = next(val_loaders[st])
            data, w = self._put_val(batch["data"])
            if st == OPT:
                loss_real_C -= float(self.val_opt_step(self.state, data, w))
            else:
                loss_fake, l_sim, sample_hat, atten = self.val_subopt_step(self.state, data, w)
                loss_fake = float(loss_fake)
                loss_fake_C += loss_fake
                loss_G -= loss_fake
                loss_sim += float(l_sim)
                if i == 0 and collect_images:
                    n = len(batch["data"])  # without the padding to the ranks
                    loggable.append((batch, data[:n], sample_hat[:n], atten[:n]))
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

    def _put_val(self, data):
        """(data, validity weights) on the state's device. The batch is
        padded to the host's ranks (repeating its first sample, weight 0)
        and the rank keeps its share: the val steps' masked reductions drop
        the padding exactly (the JAX Trainer's ``_put_val``)."""
        dev = self.state.device
        data = torch.as_tensor(data, device=dev)
        data, w = pad_batch_to_multiple(data, self.mesh.ranks_per_host)
        keep = self.mesh.batch_slice(data.shape[0])
        return data[keep], torch.as_tensor(w[keep], device=dev)

    def _log_train_images(self, subopt, mask, names, iteration: int, rng_before=None):
        """Render the batch the step trained on: with on-device augmentation
        the preview re-derives it from ``rng_before``; otherwise the batch
        arrived as it trained (host-augmented or not augmented). The logger
        gets what the JAX Trainer hands it: the first ``len(names)`` samples
        (all where there are no names) of the scaled sample, the
        reconstruction, the attenuation and the mask, ``(n, W, H, D)`` (2D:
        ``(n, W, H)``), as float32 numpy arrays."""
        n = len(names) if names else mask.shape[0]
        if self._preview_step is not None and rng_before is not None:
            sample, sample_hat, atten, mask = self._preview_step(self.state, rng_before, subopt, mask)
        else:
            w = torch.ones((subopt.shape[0],), device=self.state.device)
            _, _, sample_hat, atten = self.val_subopt_step(self.state, subopt, w)
            sample = self.step_cfg.scaler(subopt.float()).unsqueeze(1)
            mask = mask.unsqueeze(1)
        host = lambda t: t[:n, 0].detach().float().cpu().numpy()
        self.logger_interface.log_images(host(sample), host(sample_hat), host(atten), host(mask), names,
                                         iteration, "train")

    def _data_state(self, loaders: Dict[int, Iterable], action: str, step: int):
        """Save or restore the loaders' stream states beside the model
        checkpoint (loaders without get_state/set_state are skipped)."""
        stateful = {k: v for k, v in loaders.items() if hasattr(v, "get_state") and hasattr(v, "set_state")}
        if not stateful:
            return
        # the ranks of a host share its loaders' streams: one writes them
        host = (self.mesh.host_index, self.mesh.hosts)
        if action == "save":
            if self.mesh.local_index == 0 and self.mesh.space_index == 0:
                ckpt_lib.save_data_state(stateful, self.cfg.checkpoint_dir, step, *host)
        else:
            ckpt_lib.maybe_restore_data_state(stateful, self.cfg.checkpoint_dir, step, *host)

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
