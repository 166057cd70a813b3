"""Numerical debugging (counterpart of ``contrast_gan_3d_tpu/utils/debug.py``;
the reference's ``--debug`` is ``torch.autograd.set_detect_anomaly``,
reference ``train.py:242-247``).

- :func:`enable_nan_debugging` turns autograd's anomaly mode on: a backward
  that produces a NaN raises with the forward op that made it, as JAX's
  ``jax_debug_nans`` reports its primitive.
- :func:`check_finite` raises when a step's metrics are not finite (the
  forward's losses, which anomaly mode does not check), naming the
  iteration; ``Trainer.fit`` runs it after every dispatch while anomaly
  mode is on.

Anomaly mode synchronises with the card at every backward op, and cannot
run inside a captured CUDA graph: the train CLI's ``--debug`` therefore
dispatches every iteration eagerly (``cycle_length`` 1), and says so.
"""

import math
from typing import Dict

import torch


def enable_nan_debugging(enable: bool = True) -> None:
    """Autograd's anomaly detection on (or off), process-wide."""
    torch.autograd.set_detect_anomaly(enable)


def check_finite(metrics: Dict[str, torch.Tensor], iteration: int) -> None:
    """Raise ``FloatingPointError`` if a metric is NaN or infinite (reads
    every metric on the host: a sync with the card)."""
    bad = {k: float(v) for k, v in metrics.items() if not math.isfinite(float(v))}
    if bad:
        raise FloatingPointError(f"non-finite train metrics at iteration {iteration}: {bad}")
