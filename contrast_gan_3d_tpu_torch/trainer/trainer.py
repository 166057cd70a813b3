"""The schedule-driven train step (counterpart of the step-driving part of
``contrast_gan_3d_tpu/trainer/trainer.py``): ``Trainer._assemble`` joins
the three patch streams, ``Trainer.train_step`` picks the iteration's
branch. ``fit``, logging, checkpoints, validation cadence and preemption
are not ported yet (ROADMAP).
"""

from typing import Callable, Dict, Optional

import torch
from torch import nn

from contrast_gan_3d_tpu_torch.trainer.optim import ScheduledOptimizer
from contrast_gan_3d_tpu_torch.trainer.steps import StepConfig, build_train_steps, init_state

# the keys of a patches dict: the JAX package's ScanType values
OPT, LOW, HIGH = 0, -1, 1


def _due(iteration: int, every: Optional[int]) -> bool:
    return every is not None and iteration % every == 0


class Trainer:
    """Owns the train state and steps; ``train_step(patches, iteration)``
    runs the branch that the schedule (critic every ``train_critic_every``,
    generator every ``train_generator_every`` iterations, iteration 0
    included) makes due."""

    def __init__(
        self,
        generator: nn.Module,
        critic: nn.Module,
        gen_tx: Callable[..., ScheduledOptimizer],
        critic_tx: Callable[..., ScheduledOptimizer],
        step_config: Optional[StepConfig] = None,
        train_critic_every: Optional[int] = 1,
        train_generator_every: Optional[int] = 5,
        seed: int = 0,
        device="cuda",
    ):
        self.state = init_state(generator, critic, gen_tx, critic_tx, seed=seed, device=device)
        self.steps = build_train_steps(step_config or StepConfig())
        self.train_critic_every = train_critic_every
        self.train_generator_every = train_generator_every

    def _assemble(self, patches: Dict[int, Dict]) -> tuple:
        """3-stream batches -> (opt, subopt, subopt_mask, names) on the
        state's device; the sub-optimal streams join in the order LOW, HIGH."""
        dev = self.state.device
        low, high = patches[LOW], patches[HIGH]
        names = list(low.get("name", [])) + list(high.get("name", []))
        opt = torch.as_tensor(patches[OPT]["data"]).to(dev)
        subopt = torch.cat([torch.as_tensor(low["data"]).to(dev), torch.as_tensor(high["data"]).to(dev)])
        mask = torch.cat([torch.as_tensor(low["seg"]).to(dev), torch.as_tensor(high["seg"]).to(dev)])
        return opt, subopt, mask, names

    def train_step(self, patches: Dict[int, Dict], iteration: int):
        """One schedule-aware step; returns (metrics, (subopt, mask, names))."""
        opt, subopt, mask, names = self._assemble(patches)
        critic_due = _due(iteration, self.train_critic_every)
        gen_due = _due(iteration, self.train_generator_every)
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
