"""Plain reference of whole-volume correction (xqz-u/contrast-gan-3D's
inference: ``corrected = volume - attenuation``), float32, on the
generator of ``model.py`` in eval mode.

3D: a sliding window of ``patch`` voxels at stride ``round(p * (1 -
overlap))`` per axis, the last window of each axis flush with the volume's
end; every window's attenuation is weighted by a separable Gaussian (sigma
p / 8 per axis, peak 1, each axis floored at 0.01), summed, and divided by
the summed weights. Axes shorter than the patch are edge-padded around the
volume first. 2D: every axial slice (the last axis) through the 2D
generator on its own. The result is in HU, float32.
"""

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from benchmark.reference import model


def starts(dim: int, patch: int, stride: int):
    if dim <= patch:
        return [0]
    return list(range(0, dim - patch, stride)) + [dim - patch]


def window_1d(p: int, device) -> torch.Tensor:
    x = torch.arange(p, dtype=torch.float64, device=device)
    g = torch.exp(-0.5 * ((x - (p - 1) / 2) / (p / 8)) ** 2)
    return torch.clamp(g / g.max(), min=1e-2)


def num_windows(shape: Sequence[int], patch: Sequence[int], overlap: float) -> int:
    stride = [max(1, round(p * (1 - overlap))) for p in patch]
    return math.prod(len(starts(max(d, p), p, s)) for d, p, s in zip(shape, patch, stride))


@torch.no_grad()
def correct_3d(gen_params: Dict[str, torch.Tensor], running: Dict[str, torch.Tensor], arch: dict,
               volume: torch.Tensor, patch: Sequence[int], overlap: float, batch: int,
               prec: Optional[str] = None) -> torch.Tensor:
    """The corrected (W, H, D) volume in HU, on ``volume``'s device."""
    dev = volume.device
    shape = tuple(volume.shape)
    target = [max(d, p) for d, p in zip(shape, patch)]
    lo = [(t - d) // 2 for d, t in zip(shape, target)]
    x = model.scale(volume)
    if target != list(shape):
        pads = [v for d, t, l in reversed(list(zip(shape, target, lo))) for v in (l, t - d - l)]
        x = F.pad(x[None, None], pads, mode="replicate")[0, 0]
    stride = [max(1, round(p * (1 - overlap))) for p in patch]
    w1 = [window_1d(p, dev) for p in patch]
    window = (w1[0][:, None, None] * w1[1][None, :, None] * w1[2][None, None, :]).float()
    acc = torch.zeros_like(x)
    wsum = torch.zeros_like(x)
    corners = [(a, b, c) for a in starts(target[0], patch[0], stride[0])
               for b in starts(target[1], patch[1], stride[1]) for c in starts(target[2], patch[2], stride[2])]
    for i in range(0, len(corners), batch):
        group = corners[i: i + batch]
        xs = torch.stack([x[a: a + patch[0], b: b + patch[1], c: c + patch[2]] for a, b, c in group])
        att = model.generator(gen_params, xs[:, None], arch["n_resnet_blocks"], arch["n_updownsample_blocks"],
                              train=False, running=running, prec=prec)[:, 0]
        for (a, b, c), y in zip(group, att):
            acc[a: a + patch[0], b: b + patch[1], c: c + patch[2]] += y * window
            wsum[a: a + patch[0], b: b + patch[1], c: c + patch[2]] += window
    out = x - acc / wsum
    out = out[lo[0]: lo[0] + shape[0], lo[1]: lo[1] + shape[1], lo[2]: lo[2] + shape[2]]
    return model.unscale(out)


@torch.no_grad()
def correct_2d(gen_params: Dict[str, torch.Tensor], running: Dict[str, torch.Tensor], arch: dict,
               volume: torch.Tensor, batch: int, prec: Optional[str] = None) -> torch.Tensor:
    """The corrected (W, H, D) volume in HU, slice by slice along D."""
    x = model.scale(volume).permute(2, 0, 1)  # (D, W, H)
    out = torch.empty_like(x)
    for i in range(0, x.shape[0], batch):
        xs = x[i: i + batch, None]
        att = model.generator(gen_params, xs, arch["n_resnet_blocks"], arch["n_updownsample_blocks"],
                              train=False, running=running, prec=prec)
        out[i: i + batch] = (xs - att)[:, 0]
    return model.unscale(out.permute(1, 2, 0))
