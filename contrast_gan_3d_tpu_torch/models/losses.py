"""WGAN losses (counterpart of ``contrast_gan_3d_tpu/models/losses.py``).

- ``wasserstein_loss``: mean(fake) - mean(real).
- ``zncc_loss``: negative zero-normalized cross-correlation whose std has
  the eps-stabilized backward of ``StableStd`` (the JAX ``_stable_std_bwd``).
- ``hu_loss``: masked two-sided MSE corridor on centerline voxels, with a
  denominator that stays finite for an all-zero mask.
- ``gradient_penalty``: WGAN-GP on eps-interpolated samples, the critic
  differentiated with respect to its input with ``create_graph=True`` so the
  caller's backward reaches the critic's parameters.
- ``scale_bounds``: the intensity scaler applied to the HU corridor.

On bf16 inputs the losses round as the JAX functions do: a mean or sum
accumulates in f32 and returns the input's dtype (``jnp.mean``), the std
is computed in f32 and returned in the input's dtype (``jnp.std``), and
elementwise work stays in the input's dtype; the HU loss's f32 mask makes
it f32.
"""

from typing import Callable, Optional, Tuple

import numpy as np
import torch


def _mean(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean``: accumulated in f32, returned in x's dtype."""
    return x.mean(dtype=torch.float32).to(x.dtype)


def wasserstein_loss(fake: torch.Tensor, real: Optional[torch.Tensor] = None) -> torch.Tensor:
    ret = _mean(fake)
    if real is not None:
        ret = ret - _mean(real)
    return ret


class StableStd(torch.autograd.Function):
    """std with ddof=1; backward ``(2/(n-1)) * g / (2*std + 1e-6) * (x - mean)``
    (the 1e-6 keeps a near-constant input's gradient finite)."""

    @staticmethod
    def forward(ctx, x):
        std = torch.std(x.float(), correction=1).to(x.dtype)
        ctx.save_for_backward(x, std)
        return std

    @staticmethod
    def backward(ctx, g):
        x, std = ctx.saved_tensors
        n = x.numel()
        return (2.0 / (n - 1.0)) * (g / (std * 2 + 1e-6)) * (x - _mean(x))


def zncc_loss(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """-ZNCC(source, target) over the whole batch."""
    cc = _mean((source - _mean(source)) * (target - _mean(target)))
    std = StableStd.apply(source) * StableStd.apply(target)
    return -(cc / (std + 1e-8))


def hu_loss(batch: torch.Tensor, mask: torch.Tensor, min_hu: float, max_hu: float) -> torch.Tensor:
    """Two-sided HU-corridor MSE on masked (centerline) voxels; ``min_hu`` /
    ``max_hu`` are in scaled units (``scale_bounds``)."""
    below = torch.square(torch.clamp(batch, max=min_hu) - min_hu)
    above = torch.square(torch.clamp(batch, min=max_hu) - max_hu)
    loss = (below + above) * mask
    return loss.sum() / (mask.sum() + 1e-8)


def gradient_penalty(
    critic_fn: Callable[[torch.Tensor], torch.Tensor],
    real: torch.Tensor,
    fake: torch.Tensor,
    generator: torch.Generator,
    lambda_: float = 10.0,
    eps: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """WGAN-GP: ``lambda_ * mean((||d critic(interp) / d interp||_2 - 1)^2)``
    on ``interp = eps * real + (1 - eps) * fake``.

    ``real`` and ``fake`` must carry no graph (the penalty differentiates
    only the critic). When batch sizes differ, both are resampled to the
    smaller one with ``generator``; ``eps`` (broadcastable to ``(n, 1, ...)``)
    fixes the interpolation, else it is drawn uniform per sample in
    ``real``'s dtype, in which the interpolation runs."""
    n = min(real.shape[0], fake.shape[0])
    dev = real.device
    if real.shape[0] != fake.shape[0]:
        real = real[torch.randint(0, real.shape[0], (n,), generator=generator, device=dev)]
        fake = fake[torch.randint(0, fake.shape[0], (n,), generator=generator, device=dev)]
    if eps is None:
        eps = torch.rand((n,) + (1,) * (real.dim() - 1), generator=generator, device=dev, dtype=real.dtype)
    interp = (eps * real + (1.0 - eps) * fake).requires_grad_(True)
    (grads,) = torch.autograd.grad(critic_fn(interp).sum(), interp, create_graph=True)
    sq = grads.reshape(n, -1).square().sum(-1, dtype=torch.float32).to(grads.dtype)
    grad_norms = torch.sqrt(sq + 1e-12)
    return lambda_ * _mean((grad_norms - 1.0).square())


def scale_bounds(scaler, bounds: Tuple[float, float]) -> Tuple[float, float]:
    """The intensity scaler applied to the desired HU corridor, in f32."""
    return tuple(float(scaler(np.float32(b))) for b in bounds)
