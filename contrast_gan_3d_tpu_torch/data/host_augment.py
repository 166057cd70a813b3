"""Spatial augmentation on the host, inside the loaders' worker threads
(counterpart of ``HostAugmenter`` in ``contrast_gan_3d_tpu/data/
host_augment.py``).

The parameters are drawn from a ``np.random.Generator`` with the same
calls in the same order as the JAX package, so the same seed gives the
same transforms. ``HostAugmenter`` warps with the native C++ warp
(``native.warp_augment_int16``), as the JAX package does: ``src = A @
(dst - c) + c + amp * elastic(dst)``, the elastic field a half-pixel linear
upsample of the coarse noise, the scan rounded as ``floor(v + 0.5)`` to
int16, the mask nearest, half to even.

``warp_int16`` is the warp's plain version, the same function on the
port's samplers over CPU tensors. Nothing on the training path calls it:
the tests and ``chip_smoke.py`` hold the native warp against it.
"""

import threading
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from contrast_gan_3d_tpu_torch import native
from contrast_gan_3d_tpu_torch.data.augment import AugmentConfig
from contrast_gan_3d_tpu_torch.ops.resample import identity_grid, nearest_sample, resize_linear, trilinear_sample


def rotation_matrix_np(angles: np.ndarray) -> np.ndarray:
    """Rz @ Ry @ Rx from per-axis radians, in float64."""
    cx, sx = np.cos(angles[0]), np.sin(angles[0])
    cy, sy = np.cos(angles[1]), np.sin(angles[1])
    cz, sz = np.cos(angles[2]), np.sin(angles[2])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


def warp_coords(shape, affine: np.ndarray, coarse: Optional[np.ndarray] = None,
                amp: Optional[np.ndarray] = None) -> torch.Tensor:
    """The (X, Y, Z, 3) source coordinates of the warp, ``A @ (dst - c) + c
    + amp * elastic(dst)``."""
    center = (torch.tensor(shape, dtype=torch.float32) - 1.0) / 2.0
    rel = identity_grid(shape) - center
    coords = rel @ torch.from_numpy(np.asarray(affine, np.float32)).T + center
    if coarse is not None:
        field_ = resize_linear(torch.from_numpy(np.asarray(coarse, np.float32))[None], shape, antialias=False)[0]
        coords = coords + field_ * torch.from_numpy(np.asarray(amp, np.float32))
    return coords


def warp_int16(
    scan: np.ndarray,
    seg: np.ndarray,
    affine: np.ndarray,
    coarse: Optional[np.ndarray] = None,
    amp: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """The plain version of ``native.warp_augment_int16``: warp one (X, Y,
    Z) int16 scan and its mask, trilinear scan rounded with floor(v + 0.5),
    nearest mask, clamp-to-edge. Counts its calls in ``warp_int16.calls``."""
    warp_int16.calls += 1
    coords = warp_coords(scan.shape, affine, coarse, amp)[None]
    out = trilinear_sample(torch.from_numpy(scan.astype(np.float32))[None], coords)[0]
    out_seg = nearest_sample(torch.from_numpy(np.ascontiguousarray(seg))[None], coords)[0]
    return torch.floor(out + 0.5).to(torch.int16).numpy(), out_seg.numpy()


warp_int16.calls = 0


@dataclass
class HostAugmenter:
    """Per-sample random spatial transforms applied in the loader workers
    through the native warp. Thread-safe: the parameter draws are locked;
    the warp runs outside."""

    cfg: AugmentConfig
    rng: np.random.Generator
    # init=False: dataclasses.replace() re-runs __init__, so every clone
    # (create_loaders replaces rng per label) gets its own lock
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, init=False, compare=False)

    def sample_params(self, shape: Tuple[int, int, int]):
        """(affine, coarse, amp, any_transform), drawn as the JAX package's
        ``HostAugmenter.sample_params`` draws them."""
        cfg, rng = self.cfg, self.rng
        affine = np.eye(3, dtype=np.float32)
        any_transform = False
        if cfg.do_rotation and rng.random() < cfg.p_rotation:
            angles = rng.uniform(-cfg.angle, cfg.angle, 3)
            affine = rotation_matrix_np(angles).astype(np.float32)
            any_transform = True
        if cfg.do_scale and rng.random() < cfg.p_scale:
            affine = affine * np.float32(rng.uniform(cfg.scale_range[0], cfg.scale_range[1]))
            any_transform = True
        coarse = amp = None
        if cfg.do_elastic and rng.random() < cfg.p_elastic:
            g = cfg.elastic_grid
            coarse = rng.uniform(-1.0, 1.0, (g, g, g, 3)).astype(np.float32)
            mag = rng.uniform(*cfg.deformation_scale)
            amp = (mag * np.asarray(shape, np.float32) / 4.0).astype(np.float32)
            any_transform = True
        return affine, coarse, amp, any_transform

    def __call__(self, scan: np.ndarray, seg: np.ndarray):
        """Maybe-augment one (X, Y, Z) int16 scan and mask pair."""
        with self._lock:
            affine, coarse, amp, any_transform = self.sample_params(scan.shape)
        if not any_transform:
            return scan, seg
        return native.warp_augment_int16(scan, seg, affine, coarse, amp)
