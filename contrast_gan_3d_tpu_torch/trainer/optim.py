"""Optimizers with a multistep schedule, and weight clipping (counterpart of
``contrast_gan_3d_tpu/trainer/optim.py``).

Adam, RMSprop (eps outside the square root, the convention the JAX package
chose to match torch) or plain SGD, each with a MultiStepLR decay
``lr * gamma^(milestones passed)``. The schedule counts the updates of THAT
optimizer: each network's schedule steps only when that network trains, so
with a generator every 5 iterations the generator decays 5x slower in
iterations, as in the JAX package.
"""

from dataclasses import dataclass
from typing import Iterable, Optional, Sequence, Tuple

import torch
from torch import nn


@dataclass
class ScheduledOptimizer:
    """A torch optimizer and its schedule, stepped together."""

    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler

    def step(self) -> None:
        self.optimizer.step()
        self.scheduler.step()


def make_optimizer(
    kind: str,
    params: Iterable[nn.Parameter],
    lr: float = 2e-4,
    betas: Tuple[float, float] = (0.5, 0.999),
    milestones: Optional[Sequence[int]] = None,
    lr_gamma: float = 0.1,
    eps: float = 1e-8,
    alpha: float = 0.99,  # rmsprop decay
) -> ScheduledOptimizer:
    params = list(params)
    if kind == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=betas, eps=eps)
    elif kind == "rmsprop":
        opt = torch.optim.RMSprop(params, lr=lr, alpha=alpha, eps=eps)
    elif kind == "sgd":
        opt = torch.optim.SGD(params, lr=lr)
    else:
        raise ValueError(f"Unknown optimizer kind {kind!r}")
    sched = torch.optim.lr_scheduler.MultiStepLR(opt, milestones=sorted(milestones or []), gamma=lr_gamma)
    return ScheduledOptimizer(opt, sched)


@torch.no_grad()
def clip_params(module: nn.Module, clip: float) -> None:
    """WGAN weight clipping, in place: clamp EVERY parameter into
    [-clip, clip], BatchNorm scale and bias included."""
    for p in module.parameters():
        p.clamp_(-clip, clip)
