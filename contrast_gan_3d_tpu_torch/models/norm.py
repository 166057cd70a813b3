"""BatchNorm with the JAX package's semantics (counterpart of
``contrast_gan_3d_tpu/models/norm.py``), channels at dim 1 (NCDHW or
NCHW), the per-sample ``LayerNorm`` of the layer-norm critic and the
``InstanceNorm`` of ``norm="instance"``.

- eval: normalize with the running statistics;
- train: normalize with the biased batch variance ``E[x^2] - E[x]^2``
  (floored at 0), and update the running EMA with the UNBIASED variance
  n/(n-1) — torch semantics, which the JAX module keeps for reference
  parity. ``momentum`` follows torch's convention: 0.1 here is flax's 0.9.
- Normalization folds into one multiply-add, ``y = x * mult + add``, with
  ``mult = scale / sqrt(var + eps)`` and ``add = bias - mean * mult``, as in
  the JAX module. The statistics accumulate in f32 whatever x's dtype
  (float64 in float64); the
  multiply-add runs in ``dtype`` (None: x's dtype), e.g. bf16, with
  ``mult`` and ``add`` cast to it.

- ``update_stats=False`` (or the ``frozen_batch_stats`` context) keeps train
  mode's batch statistics and gradients but leaves the running statistics
  as they are: the JAX package's ``_apply(..., train=True)``, which drops
  the statistics update (the critic in the generator's loss and in the
  gradient penalty, ``trainer/steps.py``).

- In a remat block's recomputation (``recompute_scope``, entered by
  ``models/blocks.remat`` in the backward) the running statistics are
  not updated again: flax discards the recompute's mutations. The batch
  statistics are still taken, and under a mesh still all-reduced (every
  rank recomputes the same blocks, so the collectives pair).

- Under a data-parallel group (``mesh``, a ``parallel/mesh.DataMesh``;
  ``set_mesh``) train mode takes its statistics over the GLOBAL batch, as
  the JAX package's GSPMD program does: the per-channel sums and sums of
  squares of every rank are all-reduced (differentiably, as
  ``SyncBatchNorm`` does), and the running variance's ``n`` is the global
  count. Under spatial partitioning a rank holds an X-slab of its samples
  and the caller passes ``rows``, the global extent of x's first spatial
  dim (slabs may be unequal), from which the count follows;
  ``InstanceNorm`` and ``LayerNorm`` then sum each sample's statistics
  over the ranks that share it (``mesh.space_sum``).

Parameters ``weight``/``bias`` (flax ``scale``/``bias``) and buffers
``running_mean``/``running_var`` (flax ``batch_stats`` ``mean``/``var``).
"""

import math
import threading
from contextlib import contextmanager
from typing import Optional

import torch
from torch import nn

from contrast_gan_3d_tpu_torch.parallel.mesh import LOCAL

_recompute = threading.local()


def stats_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype statistics and means accumulate in: f32, or x's where it
    is wider (a float64 run, as the mesh-gradient bisect runs)."""
    return torch.promote_types(x.dtype, torch.float32)


def recomputing() -> bool:
    """Whether this thread runs a remat block's recomputation."""
    return getattr(_recompute, "active", False)


class recompute_scope:
    """Mark this thread's work as a remat block's recomputation: BatchNorm
    keeps its running statistics, dropout applies its forward's mask.
    Reentrant: a double backward recomputes a block once per backward."""

    def __enter__(self):
        self._prev = recomputing()
        _recompute.active = True

    def __exit__(self, *exc):
        _recompute.active = self._prev


class BatchNorm(nn.Module):
    def __init__(
        self,
        num_features: int,
        momentum: float = 0.1,
        eps: float = 1e-5,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.update_stats = True
        self.mesh = LOCAL

    def forward(self, x: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            axes = (0,) + tuple(range(2, x.dim()))
            if rows is None:
                n = x.numel() // x.shape[1] * self.mesh.world_size
            else:  # an X-slab of a global extent ``rows``
                n = x.shape[0] * math.prod(x.shape[3:]) * rows * self.mesh.data_size
            acc = stats_dtype(x)
            sums = torch.cat([x.sum(axes, dtype=acc), x.square().sum(axes, dtype=acc)])
            mean, mean2 = (self.mesh.all_sum(sums) / n).split(x.shape[1])
            var = torch.clamp(mean2 - mean.square(), min=0.0)
            if self.update_stats and not recomputing():
                with torch.no_grad():
                    unbiased = var * (n / (n - 1)) if n > 1 else var
                    m = self.momentum
                    self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean)
                    self.running_var.copy_((1.0 - m) * self.running_var + m * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        mult = self.weight / torch.sqrt(var + self.eps)
        add = self.bias - mean * mult
        dtype = self.dtype or x.dtype
        return x.to(dtype) * mult.to(dtype).view(shape) + add.to(dtype).view(shape)


def set_mesh(module: nn.Module, mesh) -> None:
    """Run ``module`` over ``mesh`` (``parallel/mesh.LOCAL``: this device):
    every submodule that has a ``mesh`` (the norms, dropout, the conv
    blocks and the networks, which exchange halos under spatial
    partitioning) takes it."""
    for m in module.modules():
        if hasattr(m, "mesh"):
            m.mesh = mesh


@contextmanager
def frozen_batch_stats(module: nn.Module):
    """Run ``module``'s BatchNorms without updating their running statistics
    (train mode still normalizes with the batch statistics)."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    saved = [m.update_stats for m in norms]
    for m in norms:
        m.update_stats = False
    try:
        yield module
    finally:
        for m, flag in zip(norms, saved):
            m.update_stats = flag


class LayerNorm(nn.Module):
    """Per-sample normalisation over the whole ``(C, *spatial)`` map with no
    affine parameters: the JAX ``ConvBlock``'s ``norm="layer"``, flax
    ``LayerNorm(reduction_axes=(1, ..., ndim), use_bias=False,
    use_scale=False)`` (reference ``gp_layernorm.py:10-13``). As flax
    computes it: x promoted to f32, ``var = max(E[x^2] - E[x]^2, 0)``, ``y =
    (x - mean) * rsqrt(var + eps)`` in f32, then cast to ``dtype`` (None:
    x's dtype); eps is flax's 1e-6."""

    def __init__(self, eps: float = 1e-6, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.mesh = LOCAL

    def forward(self, x: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
        axes = tuple(range(1, x.dim()))
        xf = x.to(stats_dtype(x))
        if rows is None:
            mean = xf.mean(axes, keepdim=True)
            mean2 = xf.square().mean(axes, keepdim=True)
        else:
            mean, mean2 = _slab_moments(xf, axes, rows, self.mesh)
        var = torch.clamp(mean2 - mean.square(), min=0.0)
        return ((xf - mean) * torch.rsqrt(var + self.eps)).to(self.dtype or x.dtype)


def _slab_moments(xf: torch.Tensor, axes, rows: int, mesh):
    """Per-sample means of x and x^2 over ``axes`` of an X-slab (global
    extent ``rows``), summed over the ranks that share the samples."""
    count = rows * math.prod(xf.shape[d] for d in axes if d != 2)
    keep = (-1,) + tuple(xf.shape[d] if d not in axes else 1 for d in range(1, xf.dim()))
    sums = mesh.space_sum(torch.cat([xf.sum(axes).reshape(xf.shape[0], -1),
                                     xf.square().sum(axes).reshape(xf.shape[0], -1)], 1)) / count
    mean, mean2 = sums.split(sums.shape[1] // 2, 1)
    return mean.reshape(keep), mean2.reshape(keep)


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalisation over the spatial dims with a
    learnable scale and bias: the JAX ``ConvBlock``'s ``norm="instance"``,
    flax ``GroupNorm(num_groups=None, group_size=1)`` with its defaults
    (eps 1e-6, ``use_fast_variance``, f32 reductions). As flax computes it:
    x promoted to f32, ``var = max(E[x^2] - E[x]^2, 0)``, ``y = (x - mean) *
    (rsqrt(var + eps) * scale) + bias`` in f32, then cast to ``dtype`` (None:
    x's dtype). No running statistics: train and eval mode are the same,
    and under data parallelism no statistic crosses ranks (under spatial
    partitioning a sample's cross its slabs). Parameters ``weight`` /
    ``bias`` (flax ``GroupNorm_0/scale`` / ``bias``)."""

    def __init__(self, num_features: int, eps: float = 1e-6, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.mesh = LOCAL

    def forward(self, x: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
        axes = tuple(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.to(stats_dtype(x))
        if rows is None:
            mean = xf.mean(axes, keepdim=True)
            mean2 = xf.square().mean(axes, keepdim=True)
        else:
            mean, mean2 = _slab_moments(xf, axes, rows, self.mesh)
        var = torch.clamp(mean2 - mean.square(), min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.view(shape)
        return ((xf - mean) * mul + self.bias.view(shape)).to(self.dtype or x.dtype)
