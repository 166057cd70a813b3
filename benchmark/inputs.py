"""CT-like inputs made on the device from the seed.

A phantom is an int16 HU volume: air at -1024, an elliptic soft-tissue body
(20-60 HU) with a textured background, a bone disk (600-900 HU), and
contrast-filled tubes running along the last axis on sinusoidal paths
(radius 1.5-4 voxels) at a HU drawn per tube from the requested range, plus
Gaussian noise (sigma 15 HU). Its mask marks the voxels within one voxel of
a tube's centerline, the sub-optimal scans' centerline masks that the HU
corridor loss reads. A phantom of depth 1 is a 2D slice. Every sample
draws its own geometry, so no two rows of a batch are alike.
"""

import math
from typing import Sequence, Tuple

import torch

TUBES = 3
NOISE_HU = 15.0


def phantoms(gen: torch.Generator, n: int, shape: Sequence[int], hu_range: Sequence[float], device
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(volumes, masks), both int16 ``(n, *shape)`` on ``device``; ``shape``
    is (X, Y, Z)."""
    X, Y, Z = shape
    f32 = dict(device=device, dtype=torch.float32)
    u = torch.rand((n, 9 + 7 * TUBES), generator=gen, **f32)
    x = torch.arange(X, **f32).view(1, X, 1, 1)
    y = torch.arange(Y, **f32).view(1, 1, Y, 1)
    z = torch.arange(Z, **f32).view(1, 1, 1, Z)

    def p(i, lo, hi):
        return (lo + (hi - lo) * u[:, i]).view(n, 1, 1, 1)

    # body: an ellipse in (x, y), soft tissue with a slow texture
    cx, cy = p(0, 0.35, 0.65) * X, p(1, 0.35, 0.65) * Y
    ax, ay = p(2, 0.35, 0.6) * X, p(3, 0.35, 0.6) * Y
    inside = ((x - cx) / ax) ** 2 + ((y - cy) / ay) ** 2 <= 1.0
    tissue = p(4, 20.0, 60.0) + 25.0 * torch.sin(x / 9.0 + 6.3 * p(5, 0, 1)) * torch.cos(y / 11.0 + z / 13.0)
    vol = torch.where(inside, tissue, torch.full_like(tissue, -1024.0))
    # bone: a disk below the body's centre
    bx, by, br = cx, cy + 0.5 * ay, p(6, 0.04, 0.07) * X
    vol = torch.where((x - bx) ** 2 + (y - by) ** 2 <= br**2, p(7, 600.0, 900.0), vol)
    mask = torch.zeros((n, X, Y, Z), dtype=torch.bool, device=device)
    lo_hu, hi_hu = float(hu_range[0]), float(hu_range[1])
    for t in range(TUBES):
        k = 9 + 7 * t
        x0, y0 = p(k, 0.25, 0.75) * X, p(k + 1, 0.25, 0.75) * Y
        amp = p(k + 2, 0.02, 0.12) * min(X, Y)
        period, phase = p(k + 3, 60.0, 240.0), p(k + 4, 0.0, 2 * math.pi)
        radius, hu = p(k + 5, 1.5, 4.0), p(k + 6, lo_hu, hi_hu)
        angle = 2 * math.pi * z / period + phase
        d2 = (x - x0 - amp * torch.sin(angle)) ** 2 + (y - y0 - amp * torch.cos(angle)) ** 2
        vol = torch.where(d2 <= radius**2, hu, vol)
        mask |= d2 <= 1.0
    vol = vol + NOISE_HU * torch.randn((n, X, Y, Z), generator=gen, **f32)
    vol = vol.round_().clamp_(-1024, 1500).to(torch.int16)
    return vol, mask.to(torch.int16)
