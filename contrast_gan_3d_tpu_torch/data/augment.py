"""Spatial augmentation on the device (counterpart of the 3D part of
``contrast_gan_3d_tpu/data/augment.py``): per-sample rotation (p=0.2,
+-30 deg per axis), isotropic scaling (p=0.2, 0.7-1.4) and elastic
deformation (p=0.1, amplitude (0, 0.25) of the patch extent / 4), composed
into ONE coordinate field per sample; the scan is resampled trilinearly,
the mask nearest, both clamp-to-edge.

The JAX package draws from a JAX PRNG key, which torch cannot reproduce.
So the work is split in two:
- :func:`draw`: every random number of a batch, from an explicit
  ``torch.Generator``, into an :class:`AugmentDraws`;
- :func:`coords_from_draws`: the deterministic field, which the parity
  tests feed with draws rebuilt from a JAX key.

The elastic field is ``jax.image.resize(coarse, ..., "linear")`` exactly:
the triangle kernel, antialiased on axes that shrink below
``elastic_grid`` (``ops/resample.resize_weights``), so any patch shape
matches. The 2D ``Augment2DConfig`` path is not ported (ROADMAP).
"""

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from contrast_gan_3d_tpu_torch.ops.resample import (
    identity_grid,
    nearest_sample,
    resize_linear,
    rotation_matrix,
    trilinear_sample,
)


@dataclass(frozen=True)
class AugmentConfig:
    # elastic deformation
    do_elastic: bool = True
    deformation_scale: Tuple[float, float] = (0.0, 0.25)
    p_elastic: float = 0.1
    elastic_grid: int = 8  # coarse noise grid resolution per axis
    # scaling
    do_scale: bool = True
    scale_range: Tuple[float, float] = (0.7, 1.4)
    p_scale: float = 0.2
    # rotation
    do_rotation: bool = True
    angle: float = 30.0 * math.pi / 180.0  # +- bound per axis, radians
    p_rotation: float = 0.2


class AugmentDraws(NamedTuple):
    """The random numbers of one batch of B samples. A gate is a (B,) bool;
    the transforms whose gate is off leave the sample as it is."""

    rot_gate: torch.Tensor      # (B,)
    angles: torch.Tensor        # (B, 3) radians
    scale_gate: torch.Tensor    # (B,)
    scale: torch.Tensor         # (B,)
    elastic_gate: torch.Tensor  # (B,)
    elastic_mag: torch.Tensor   # (B,) fraction of the extent / 4
    coarse: torch.Tensor        # (B, g, g, g, 3) in [-1, 1)

    def to(self, device) -> "AugmentDraws":
        return AugmentDraws(*(t.to(device) for t in self))


def draw(generator: torch.Generator, batch: int, cfg: AugmentConfig) -> AugmentDraws:
    """All of a batch's draws, on the generator's device, in this fixed
    order (every draw is made whatever ``cfg`` switches off, so the stream
    does not depend on it): the rotation gates, the angles, the scale
    gates, the scales, the elastic gates, the elastic magnitudes, the
    coarse noise."""
    dev = generator.device

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator, device=dev)

    def gate(p):
        return torch.rand((batch,), generator=generator, device=dev) < p

    rot_gate = gate(cfg.p_rotation)
    angles = uniform((batch, 3), -cfg.angle, cfg.angle)
    scale_gate = gate(cfg.p_scale)
    scale = uniform((batch,), *cfg.scale_range)
    elastic_gate = gate(cfg.p_elastic)
    mag = uniform((batch,), *cfg.deformation_scale)
    g = cfg.elastic_grid
    coarse = uniform((batch, g, g, g, 3), -1.0, 1.0)
    return AugmentDraws(rot_gate, angles, scale_gate, scale, elastic_gate, mag, coarse)


def elastic_field(coarse: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """(B, g, g, g, 3) coarse noise -> (B, X, Y, Z, 3) displacement field,
    ``jax.image.resize(..., "linear")`` per sample."""
    return resize_linear(coarse, shape, antialias=True)


def coords_from_draws(draws: AugmentDraws, shape: Sequence[int], cfg: AugmentConfig) -> torch.Tensor:
    """(B, X, Y, Z, 3) sampling coordinates, the JAX ``_sample_coords``
    per sample: rotation, then scale about the patch centre, then the gated
    elastic displacement."""
    dev = draws.angles.device
    shape = tuple(int(s) for s in shape)
    extent = torch.tensor(shape, dtype=torch.float32, device=dev)
    center = (extent - 1.0) / 2.0
    rel = (identity_grid(shape, dev) - center).unsqueeze(0)  # (1, X, Y, Z, 3)
    B = draws.angles.shape[0]
    if cfg.do_rotation:
        rot = rotation_matrix(torch.where(draws.rot_gate[:, None], draws.angles, 0.0))
        rel = (rel.reshape(1, -1, 3) @ rot.transpose(1, 2)).reshape(B, *shape, 3)
    if cfg.do_scale:
        rel = rel * torch.where(draws.scale_gate, draws.scale, 1.0).reshape(-1, 1, 1, 1, 1)
    coords = (rel + center).expand(B, *shape, 3)
    if cfg.do_elastic:
        field = elastic_field(draws.coarse, shape)
        amplitude = draws.elastic_mag[:, None] * extent / 4.0  # (B, 3)
        gate = draws.elastic_gate.to(torch.float32).reshape(-1, 1, 1, 1, 1)
        coords = coords + gate * field * amplitude.reshape(-1, 1, 1, 1, 3)
    return coords


def augment_batch(
    data: torch.Tensor, seg: Optional[torch.Tensor], draws: AugmentDraws, cfg: AugmentConfig = AugmentConfig()
):
    """Augment a (B, X, Y, Z) f32 scan batch and its (B, X, Y, Z) mask batch
    (or ``seg=None``: data only, as for the OPT stream) with one coordinate
    field per sample: (data, seg) resampled."""
    if data.dim() != 4:
        raise NotImplementedError("augmentation of 2D batches (Augment2DConfig) is not ported yet (ROADMAP)")
    coords = coords_from_draws(draws, data.shape[1:], cfg)
    return trilinear_sample(data, coords), None if seg is None else nearest_sample(seg, coords)
