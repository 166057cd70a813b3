"""Named host spans at the port's layer boundaries.

``span("<layer>.<part>")`` is a ``torch.profiler.record_function`` range
while a profiler is running, and a shared do-nothing context otherwise: a
running profiler is what turns spans on, and nothing else does. The ranges
land in the profiler's own trace (the train CLI's ``--profiler-*`` Chrome
traces, the benchmark's stretch) on the device's clock, so the host's
ranges, the kernel launches inside them and the kernels line up there; the
program stores and exports nothing itself.

The names: ``train.*`` (``Trainer.train_step_cycle`` and
``trainer/steps.CycleStep``), ``correct.*`` (the corrector, the sliding
window, the sharded corrector) and ``gen.<stage>`` (the generator's
stages, ``ResnetGenerator.stage_names``). A replayed CUDA graph has no host
side, so a replay shows as one ``train.replay`` span with no ``gen.*``
inside.
"""

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a profiler runs, else the
    shared null context (a check of a flag: well under a microsecond)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
