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

Under a data-parallel group (``mesh``, a ``parallel/mesh.DataMesh``) every
batch reduction runs over the GLOBAL batch, as the JAX package's GSPMD
program computes it: means, the ZNCC's ddof=1 std, the HU loss's sums and
the penalty's mean are this rank's partial sums all-reduced
(``mesh.all_sum``), never per-rank losses averaged across ranks. Under
spatial partitioning a rank holds an X-slab of its samples (and of the
critic's logits, in slabs that need not be equal): the counts come from
the global shapes (``mesh.numel``; the logits' global extent is the
caller's ``rows``), and the penalty sums each sample's squared gradient
over its slabs (``mesh.space_sum``) before the root.

On bf16 inputs the losses round as the JAX functions do: a mean or sum
accumulates in f32 and returns the input's dtype (``jnp.mean``), the std
is computed in f32 and returned in the input's dtype (``jnp.std``), and
elementwise work stays in the input's dtype; the HU loss's f32 mask makes
it f32.
"""

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from contrast_gan_3d_tpu_torch.models.norm import stats_dtype
from contrast_gan_3d_tpu_torch.parallel.mesh import LOCAL


def _mean(x: torch.Tensor, mesh=LOCAL, rows: Optional[int] = None) -> torch.Tensor:
    """``jnp.mean``: accumulated in f32 (float64 in float64), returned in
    x's dtype; over ``mesh``'s global batch (``rows``: x is an X-slab of
    that extent)."""
    return (mesh.all_sum(x.sum(dtype=stats_dtype(x))) / mesh.numel(x, rows)).to(x.dtype)


def wasserstein_loss(fake: torch.Tensor, real: Optional[torch.Tensor] = None, mesh=LOCAL,
                     rows: Optional[int] = None) -> torch.Tensor:
    """mean(fake) - mean(real) over the global batch; ``rows``: the logits
    are X-slabs of that global extent."""
    ret = _mean(fake, mesh, rows)
    if real is not None:
        ret = ret - _mean(real, mesh, rows)
    return ret


class StableStd(torch.autograd.Function):
    """std with ddof=1; backward ``(2/(n-1)) * g / (2*std + 1e-6) * (x - mean)``
    (the 1e-6 keeps a near-constant input's gradient finite). The std, its
    mean and ``n`` are ``mesh``'s global batch's, and the backward sums the
    ranks' incoming gradients (``mesh.all_sum``'s convention)."""

    @staticmethod
    def forward(ctx, x, mesh=LOCAL):
        n = mesh.numel(x)
        xf = x.to(stats_dtype(x))
        mean = mesh.all_sum(xf.sum()) / n
        var = mesh.all_sum((xf - mean).square().sum()) / (n - 1)
        std = torch.sqrt(var).to(x.dtype)
        ctx.save_for_backward(x, std, mean.to(x.dtype))
        ctx.mesh, ctx.n = mesh, n
        return std

    @staticmethod
    def backward(ctx, g):
        x, std, mean = ctx.saved_tensors
        g = ctx.mesh.all_sum(g)
        return (2.0 / (ctx.n - 1.0)) * (g / (std * 2 + 1e-6)) * (x - mean), None


def zncc_loss(source: torch.Tensor, target: torch.Tensor, mesh=LOCAL) -> torch.Tensor:
    """-ZNCC(source, target) over the whole (global) batch."""
    cc = _mean((source - _mean(source, mesh)) * (target - _mean(target, mesh)), mesh)
    std = StableStd.apply(source, mesh) * StableStd.apply(target, mesh)
    return -(cc / (std + 1e-8))


def hu_loss(batch: torch.Tensor, mask: torch.Tensor, min_hu: float, max_hu: float, mesh=LOCAL) -> torch.Tensor:
    """Two-sided HU-corridor MSE on masked (centerline) voxels; ``min_hu`` /
    ``max_hu`` are in scaled units (``scale_bounds``). ``sum(loss) /
    sum(mask)`` over the whole (global) batch."""
    below = torch.square(torch.clamp(batch, max=min_hu) - min_hu)
    above = torch.square(torch.clamp(batch, min=max_hu) - max_hu)
    loss, count = mesh.all_sum(((below + above) * mask).sum()), mesh.all_sum(mask.sum())
    return loss / (count + 1e-8)


def gradient_penalty(
    critic_fn: Callable[[torch.Tensor], torch.Tensor],
    real: torch.Tensor,
    fake: torch.Tensor,
    generator: torch.Generator,
    lambda_: float = 10.0,
    eps: Optional[torch.Tensor] = None,
    mesh=LOCAL,
) -> torch.Tensor:
    """WGAN-GP: ``lambda_ * mean((||d critic(interp) / d interp||_2 - 1)^2)``
    on ``interp = eps * real + (1 - eps) * fake``.

    ``real`` and ``fake`` must carry no graph (the penalty differentiates
    only the critic). When batch sizes differ, both are resampled to the
    smaller one with ``generator``; ``eps`` (broadcastable to ``(n, 1, ...)``)
    fixes the interpolation, else it is drawn uniform per sample in
    ``real``'s dtype, in which the interpolation runs.

    ``real`` and ``fake`` are this rank's shares of ``mesh``'s global
    batch: the resampling indices and ``eps`` are drawn for the global
    batch on every rank (the generators stay in lockstep) and each rank
    keeps its data index's slice; the resampled global count must divide
    the data ranks. Under spatial partitioning they are X-slabs, and each
    sample's squared gradient norm is summed over its slabs."""
    n = min(real.shape[0], fake.shape[0])
    dev = real.device
    if real.shape[0] != fake.shape[0]:
        real, fake = mesh.all_gather(real), mesh.all_gather(fake)
        n = min(real.shape[0], fake.shape[0])
        real = real[torch.randint(0, real.shape[0], (n,), generator=generator, device=dev)]
        fake = fake[torch.randint(0, fake.shape[0], (n,), generator=generator, device=dev)]
        if n % mesh.data_size:
            raise ValueError(f"the gradient penalty resamples {n} pairs, which do not split over "
                             f"{mesh.data_size} ranks")
        n //= mesh.data_size
        keep = mesh.global_slice(n)
        real, fake = real[keep], fake[keep]
    if eps is None:
        eps = torch.rand((n * mesh.data_size,) + (1,) * (real.dim() - 1), generator=generator, device=dev,
                         dtype=real.dtype)[mesh.global_slice(n)]
    interp = (eps * real + (1.0 - eps) * fake).requires_grad_(True)
    (grads,) = torch.autograd.grad(critic_fn(interp).sum(), interp, create_graph=True)
    sq = mesh.space_sum(grads.reshape(n, -1).square().sum(-1, dtype=stats_dtype(grads))).to(grads.dtype)
    grad_norms = torch.sqrt(sq + 1e-12)
    return lambda_ * _mean((grad_norms - 1.0).square(), mesh)


def scale_bounds(scaler, bounds: Tuple[float, float]) -> Tuple[float, float]:
    """The intensity scaler applied to the desired HU corridor, in f32."""
    return tuple(float(scaler(np.float32(b))) for b in bounds)
