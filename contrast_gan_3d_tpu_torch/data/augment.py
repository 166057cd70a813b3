"""Spatial augmentation on the device (counterpart of
``contrast_gan_3d_tpu/data/augment.py``): per-sample rotation (p=0.2,
+-30 deg per axis), isotropic scaling (p=0.2, 0.7-1.4) and elastic
deformation (p=0.1, amplitude (0, 0.25) of the patch extent / 4), composed
into ONE coordinate field per sample; the scan is resampled trilinearly,
the mask nearest, both clamp-to-edge. The 2D family's ``Augment2DConfig``
is an in-plane rotation (p=0.5, +-2 pi) and a mirror (p=0.5, each axis
50/50) of each (X, Y) slice, resampled bilinearly (``(B, X, Y)`` batches).

The JAX package draws from a JAX PRNG key, which torch cannot reproduce.
So the work is split in two:
- :func:`draw`: every random number of a batch, from an explicit
  ``torch.Generator``, into an :class:`AugmentDraws` (2D:
  :class:`AugmentDraws2D`);
- :func:`coords_from_draws` (2D: :func:`coords_from_draws_2d`): the
  deterministic field, which the parity tests feed with draws rebuilt from
  a JAX key.

The elastic field is ``jax.image.resize(coarse, ..., "linear")`` exactly:
the triangle kernel, antialiased on axes that shrink below
``elastic_grid`` (``ops/resample.resize_weights``), so any patch shape
matches.
"""

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from contrast_gan_3d_tpu_torch.ops.resample import (
    bilinear_sample,
    identity_grid,
    nearest_sample,
    nearest_sample_2d,
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


@dataclass(frozen=True)
class Augment2DConfig(AugmentConfig):
    """conf_2D augmentation (reference ``conf_2D.py:30-56``): rotation only
    (+-360 deg, p=0.5) plus axis mirroring (p=0.5 per sample, each axis
    50/50 — batchgenerators' MirrorTransform)."""

    do_elastic: bool = False
    do_scale: bool = False
    do_rotation: bool = True
    angle: float = 2 * math.pi
    p_rotation: float = 0.5
    do_mirror: bool = True
    p_mirror: float = 0.5


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


class AugmentDraws2D(NamedTuple):
    """The random numbers of one batch of B 2D samples, each (B,)."""

    rot_gate: torch.Tensor     # bool
    angle: torch.Tensor        # radians
    mirror_gate: torch.Tensor  # bool
    flip_x: torch.Tensor       # bool, mirrors x where the mirror gate is on
    flip_y: torch.Tensor       # bool

    def to(self, device) -> "AugmentDraws2D":
        return AugmentDraws2D(*(t.to(device) for t in self))


def draw(generator: torch.Generator, batch: int, cfg: AugmentConfig):
    """All of a batch's draws, on the generator's device, in this fixed
    order (every draw is made whatever ``cfg`` switches off, so the stream
    does not depend on it): the rotation gates, the angles, the scale
    gates, the scales, the elastic gates, the elastic magnitudes, the
    coarse noise. For an ``Augment2DConfig``: the rotation gates, the
    angles, the mirror gates, the x flips, the y flips
    (:class:`AugmentDraws2D`)."""
    dev = generator.device

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator, device=dev)

    def gate(p):
        return torch.rand((batch,), generator=generator, device=dev) < p

    if isinstance(cfg, Augment2DConfig):
        rot_gate = gate(cfg.p_rotation)
        angle = uniform((batch,), -cfg.angle, cfg.angle)
        return AugmentDraws2D(rot_gate, angle, gate(cfg.p_mirror), gate(0.5), gate(0.5))
    rot_gate = gate(cfg.p_rotation)
    angles = uniform((batch, 3), -cfg.angle, cfg.angle)
    scale_gate = gate(cfg.p_scale)
    scale = uniform((batch,), *cfg.scale_range)
    elastic_gate = gate(cfg.p_elastic)
    mag = uniform((batch,), *cfg.deformation_scale)
    g = cfg.elastic_grid
    coarse = uniform((batch, g, g, g, 3), -1.0, 1.0)
    return AugmentDraws(rot_gate, angles, scale_gate, scale, elastic_gate, mag, coarse)


def _device_vector(values: Sequence[int], device) -> torch.Tensor:
    """The f32 vector ``values`` filled in on ``device``: a copy from host
    memory would not replay inside a captured CUDA graph."""
    return torch.stack([torch.full((), float(v), dtype=torch.float32, device=device) for v in values])


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
    extent = _device_vector(shape, dev)
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


def coords_from_draws_2d(draws: AugmentDraws2D, shape: Sequence[int], cfg: Augment2DConfig) -> torch.Tensor:
    """(B, X, Y, 2) sampling coordinates, the JAX ``_augment2d_one`` per
    sample: ``rel @ R.T`` for the gated angle, then ``* (mx, my)``."""
    dev = draws.angle.device
    shape = tuple(int(s) for s in shape)
    center = (_device_vector(shape, dev) - 1.0) / 2.0
    rel = (identity_grid(shape, dev) - center).unsqueeze(0)  # (1, X, Y, 2)
    B = draws.angle.shape[0]
    if cfg.do_rotation:
        a = torch.where(draws.rot_gate, draws.angle, 0.0)
        c, s = torch.cos(a), torch.sin(a)
        rot = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)  # (B, 2, 2)
        rel = (rel.reshape(1, -1, 2) @ rot.transpose(1, 2)).reshape(B, *shape, 2)
    if cfg.do_mirror:
        flips = torch.stack([draws.flip_x, draws.flip_y], -1) & draws.mirror_gate[:, None]
        rel = rel * torch.where(flips, -1.0, 1.0).reshape(B, 1, 1, 2)
    return (rel + center).expand(B, *shape, 2)


def augment_batch(data: torch.Tensor, seg: Optional[torch.Tensor], draws, cfg: AugmentConfig = AugmentConfig()):
    """Augment a (B, X, Y, Z) f32 scan batch and its (B, X, Y, Z) mask batch
    (or ``seg=None``: data only, as for the OPT stream) with one coordinate
    field per sample: (data, seg) resampled. (B, X, Y) batches take the 2D
    path (``Augment2DConfig`` and :class:`AugmentDraws2D`): bilinear scan,
    nearest mask."""
    if data.dim() == 3:
        coords = coords_from_draws_2d(draws, data.shape[1:], cfg)
        return bilinear_sample(data, coords), None if seg is None else nearest_sample_2d(seg, coords)
    coords = coords_from_draws(draws, data.shape[1:], cfg)
    return trilinear_sample(data, coords), None if seg is None else nearest_sample(seg, coords)
