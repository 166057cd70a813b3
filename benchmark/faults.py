"""Faults planted under the timed path, for the checks' tests and for the
fault readings of ``calibrate.py``. Each is a context manager that patches
the program for its duration; a sound comparison must come out not
correct under every fault the cell can have:
- ``unchanged``: training steps leave the parameters as they were;
  corrections return the volume unchanged (a zero attenuation);
- ``half_batch``: training uses half of each stream's batch (the losses'
  means over the rest); corrections drop the second half of every batch
  of windows or slices (a zero attenuation there);
- ``altered``: one voxel of every corrected volume is 50 HU off;
- ``stale_inputs``: every training cycle after the second trains on the
  second one's batches: on the card the copy of a cycle's batches into the
  captured graph's static buffers is left out (``CycleStep._copy_inputs``
  does nothing), so each replay reads the batches captured with the graph;
  an eager cycle (the CPU's) is handed the second cycle's batches.
"""

import contextlib
from unittest import mock

import torch


@contextlib.contextmanager
def unchanged():
    from contrast_gan_3d_tpu_torch.trainer.optim import ScheduledOptimizer

    real_step = ScheduledOptimizer.step

    def step(self):
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        before = [p.detach().clone() for p in params]
        real_step(self)
        with torch.no_grad():
            for p, b in zip(params, before):
                p.copy_(b)

    with mock.patch.object(ScheduledOptimizer, "step", step), _eval_outputs(torch.zeros_like):
        yield


@contextlib.contextmanager
def _eval_outputs(change):
    """The generator's eval-mode outputs (the corrector's) through
    ``change``; training is left alone."""
    from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator

    real_forward, real_packed = ResnetGenerator.forward, ResnetGenerator.forward_packed

    def forward(self, x):
        y = real_forward(self, x)
        return y if self.training else change(y)

    def forward_packed(self, x, *args, **kwargs):
        y = real_packed(self, x, *args, **kwargs)
        return y if self.training else change(y)

    with mock.patch.object(ResnetGenerator, "forward", forward), \
            mock.patch.object(ResnetGenerator, "forward_packed", forward_packed):
        yield


def _drop_second_half(y: torch.Tensor) -> torch.Tensor:
    y = y.clone()
    y[y.shape[0] - y.shape[0] // 2:] = 0
    return y


@contextlib.contextmanager
def half_batch():
    from contrast_gan_3d_tpu_torch.trainer.trainer import Trainer

    real_assemble = Trainer._assemble

    def assemble(self, patches):
        opt, subopt, mask, names = real_assemble(self, patches)
        return opt[: len(opt) // 2], subopt[: len(subopt) // 2], mask[: len(mask) // 2], names[: len(names) // 2]

    with mock.patch.object(Trainer, "_assemble", assemble), _eval_outputs(_drop_second_half):
        yield


@contextlib.contextmanager
def altered():
    from contrast_gan_3d_tpu_torch.eval.corrector import CCTAContrastCorrector

    real = CCTAContrastCorrector.correct

    def correct(self, volume):
        out = real(self, volume).clone()
        out[tuple(d // 2 for d in out.shape)] += 50.0
        return out

    with mock.patch.object(CCTAContrastCorrector, "correct", correct):
        yield


@contextlib.contextmanager
def stale_inputs():
    from contrast_gan_3d_tpu_torch.trainer.steps import CycleStep, graphed

    real_call = CycleStep.__call__

    def call(self, state, *batches):
        if not graphed(state):
            seen = self.calls["eager"]
            if seen == 1:
                self.stale_batches = tuple(b.clone() for b in batches)
            elif seen > 1:
                batches = self.stale_batches
        return real_call(self, state, *batches)

    with mock.patch.object(CycleStep, "_copy_inputs", lambda self, *batches: None), \
            mock.patch.object(CycleStep, "__call__", call):
        yield
