"""Optimizers with a multistep schedule, and weight clipping (counterpart of
``contrast_gan_3d_tpu/trainer/optim.py``).

Adam, RMSprop (eps outside the square root, the convention the JAX package
chose to match torch) or plain SGD, each with a multistep decay ``lr *
gamma^(milestones passed)`` (torch's ``MultiStepLR``, optax's
``piecewise_constant_schedule``). The schedule counts the updates of THAT
optimizer: each network's schedule steps only when that network trains, so
with a generator every 5 iterations the generator decays 5x slower in
iterations, as in the JAX package.

The update count lives on the parameters' device
(``MultiStepSchedule.count``) and the learning rate is evaluated from it
before each update:
- on a CUDA device, on the device, into the 0-d tensor the optimizer reads
  (Adam and RMSprop with ``capturable=True``, their step counts on the
  device too; SGD through ``_DeviceLrSGD``). A captured CUDA graph then
  replays the schedule, and a milestone inside a captured cycle takes
  effect at its update. Eager steps on the card run this same
  configuration, so the two agree bit for bit;
- on the CPU, on the host, as the float in the parameter group, and the
  update is torch's default CPU path.
"""

import collections
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch
from torch import nn


class MultiStepSchedule:
    """``base_lr * gamma^(milestones passed)`` after ``count`` updates, with
    ``MultiStepLR``'s rounding (the lr is multiplied by gamma at each
    milestone in turn). ``count`` is a 0-d int64 tensor on the parameters'
    device; ``lr`` is the 0-d f32 device tensor a CUDA optimizer reads
    (None on the CPU)."""

    def __init__(self, lr: float, milestones: Sequence[int], gamma: float, device):
        self.count = torch.zeros((), dtype=torch.int64, device=device)
        self.lr = torch.tensor(float(lr), dtype=torch.float32, device=device) if self.count.is_cuda else None
        self._configure(lr, milestones, gamma)

    def _configure(self, lr: float, milestones: Sequence[int], gamma: float) -> None:
        self.base_lr, self.gamma = float(lr), float(gamma)
        self.milestones = sorted(int(m) for m in milestones)
        dev = self.count.device
        # the lr after each milestone, indexed by the milestones passed
        self._milestones_t = torch.tensor(self.milestones, dtype=torch.int64, device=dev)
        self._table = torch.tensor([self.lr_at(n) for n in [0] + self.milestones], dtype=torch.float32, device=dev)

    def lr_at(self, n: int) -> float:
        """The learning rate of update ``n`` (0-based), on the host."""
        lr = self.base_lr
        for m, times in sorted(collections.Counter(self.milestones).items()):
            if n >= m:
                lr *= self.gamma**times
        return lr

    def update_device_lr(self) -> None:
        """``lr`` <- the learning rate of update ``count``, on the device."""
        passed = (self.count >= self._milestones_t).sum().reshape(1)
        self.lr.copy_(torch.index_select(self._table, 0, passed).reshape(()))

    def state_dict(self) -> Dict:
        """``MultiStepLR``'s keys: what the checkpoints of earlier versions
        hold, and read back by :meth:`load_state_dict`."""
        n = int(self.count)
        return {"milestones": dict(collections.Counter(self.milestones)), "gamma": self.gamma,
                "base_lrs": [self.base_lr], "last_epoch": n, "_last_lr": [self.lr_at(n)]}

    def load_state_dict(self, sd: Dict) -> None:
        """Restore from :meth:`state_dict` or a ``MultiStepLR.state_dict()``
        (its ``last_epoch`` is the update count)."""
        milestones = [m for m, times in dict(sd["milestones"]).items() for _ in range(times)]
        self._configure(sd["base_lrs"][0], milestones, sd["gamma"])
        self.count.fill_(int(sd["last_epoch"]))


class _DeviceLrSGD(torch.optim.SGD):
    """Plain SGD (no momentum) whose update multiplies by the device lr
    tensor on the device: torch's SGD turns a tensor lr into a host number,
    which a CUDA graph cannot capture."""

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if params:
                torch._foreach_add_(params, torch._foreach_mul([p.grad for p in params], -group["lr"]))


@dataclass
class ScheduledOptimizer:
    """A torch optimizer and its schedule, stepped together."""

    optimizer: torch.optim.Optimizer
    scheduler: MultiStepSchedule

    def step(self) -> None:
        sched = self.scheduler
        if sched.lr is None:
            for group in self.optimizer.param_groups:
                group["lr"] = sched.lr_at(int(sched.count))
        else:
            sched.update_device_lr()
        self.optimizer.step()
        sched.count += 1

    def state_dicts(self) -> Tuple[Dict, Dict]:
        """(optimizer, schedule) state dicts in the checkpoint's form: the
        groups' lr a float (the lr of the next update, as ``MultiStepLR``
        leaves it), whatever the device."""
        sd = self.optimizer.state_dict()
        lr = self.scheduler.lr_at(int(self.scheduler.count))
        for group in sd["param_groups"]:
            group["lr"] = lr
        return sd, self.scheduler.state_dict()

    def load_state_dicts(self, optimizer_sd: Dict, schedule_sd: Dict) -> None:
        """Restore from :meth:`state_dicts` (checkpoints written on either
        device or before the schedule moved to the device), then put this
        device's configuration back: on CUDA the device lr and
        ``capturable`` with the step counts on the card, on the CPU host
        floats and the step counts on the CPU."""
        self.optimizer.load_state_dict(optimizer_sd)
        self.scheduler.load_state_dict(schedule_sd)
        sched = self.scheduler
        on_card = sched.lr is not None
        for group in self.optimizer.param_groups:
            group["lr"] = sched.lr if on_card else sched.lr_at(int(sched.count))
            if "capturable" in group:
                group["capturable"] = on_card
        step_device = sched.count.device if on_card else torch.device("cpu")
        for st in self.optimizer.state.values():
            if "step" in st:
                st["step"] = st["step"].to(device=step_device, dtype=torch.float32)
        if on_card:
            sched.update_device_lr()


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
    device = params[0].device if params else torch.device("cpu")
    sched = MultiStepSchedule(lr, milestones or (), lr_gamma, device)
    on_card = sched.lr is not None
    lr_arg = sched.lr if on_card else lr
    if kind == "adam":
        opt = torch.optim.Adam(params, lr=lr_arg, betas=betas, eps=eps, capturable=on_card)
    elif kind == "rmsprop":
        opt = torch.optim.RMSprop(params, lr=lr_arg, alpha=alpha, eps=eps, capturable=on_card)
    elif kind == "sgd":
        opt = (_DeviceLrSGD if on_card else torch.optim.SGD)(params, lr=lr_arg)
    else:
        raise ValueError(f"Unknown optimizer kind {kind!r}")
    if on_card:
        sched.lr = opt.param_groups[0]["lr"]  # the tensor the groups read
    return ScheduledOptimizer(opt, sched)


@torch.no_grad()
def clip_params(module: nn.Module, clip: float) -> None:
    """WGAN weight clipping, in place: clamp EVERY parameter into
    [-clip, clip], BatchNorm scale and bias included."""
    for p in module.parameters():
        p.clamp_(-clip, clip)
