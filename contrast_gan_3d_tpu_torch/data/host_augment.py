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

``HostAugmenter2D`` is the 2D family's (rotation and mirror of each slice,
``Augment2DConfig``), through ``native.warp_augment2d_int16``; its plain
version is ``warp2d_int16``.
"""

import threading
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from contrast_gan_3d_tpu_torch import native
from contrast_gan_3d_tpu_torch.data.augment import Augment2DConfig, AugmentConfig
from contrast_gan_3d_tpu_torch.ops.resample import (
    bilinear_sample,
    identity_grid,
    nearest_sample,
    nearest_sample_2d,
    resize_linear,
    trilinear_sample,
)


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


def warp2d_int16(scan: np.ndarray, seg: np.ndarray, affine: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The plain version of ``native.warp_augment2d_int16``: warp one (W, H)
    int16 slice and its mask to ``src = A @ (dst - c) + c``, bilinear scan
    rounded with floor(v + 0.5), nearest mask, clamp-to-edge. Counts its
    calls in ``warp2d_int16.calls``."""
    warp2d_int16.calls += 1
    shape = scan.shape
    center = (torch.tensor(shape, dtype=torch.float32) - 1.0) / 2.0
    coords = ((identity_grid(shape) - center) @ torch.from_numpy(np.asarray(affine, np.float32)).T + center)[None]
    out = bilinear_sample(torch.from_numpy(scan.astype(np.float32))[None], coords)[0]
    out_seg = nearest_sample_2d(torch.from_numpy(np.ascontiguousarray(seg))[None], coords)[0]
    return torch.floor(out + 0.5).to(torch.int16).numpy(), out_seg.numpy()


warp2d_int16.calls = 0


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


@dataclass
class HostAugmenter2D:
    """The 2D family's per-slice transforms (rotation +-angle with
    p_rotation, mirroring of each axis 50/50 under a p_mirror gate) through
    the native 2D warp; the counterpart of the JAX package's
    ``HostAugmenter2D``. The mirror folds into the 2x2 affine, ``diag(mx,
    my) @ R``: the device path's ``(rel @ R.T) * (mx, my)``. Thread-safe as
    ``HostAugmenter``."""

    cfg: Augment2DConfig
    rng: np.random.Generator
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, init=False, compare=False)

    def sample_params(self):
        """(affine, any_transform), drawn as the JAX package's
        ``HostAugmenter2D.sample_params`` draws them."""
        cfg, rng = self.cfg, self.rng
        affine = np.eye(2, dtype=np.float32)
        any_transform = False
        if cfg.do_rotation and rng.random() < cfg.p_rotation:
            a = rng.uniform(-cfg.angle, cfg.angle)
            c, s = np.float32(np.cos(a)), np.float32(np.sin(a))
            affine = np.array([[c, -s], [s, c]], np.float32)
            any_transform = True
        if cfg.do_mirror and rng.random() < cfg.p_mirror:
            mx = np.float32(-1.0 if rng.random() < 0.5 else 1.0)
            my = np.float32(-1.0 if rng.random() < 0.5 else 1.0)
            affine = np.diag([mx, my]).astype(np.float32) @ affine
            any_transform = any_transform or mx < 0 or my < 0
        return affine, any_transform

    def __call__(self, scan: np.ndarray, seg: np.ndarray):
        """Maybe-augment one (W, H) int16 slice and mask pair."""
        with self._lock:
            affine, any_transform = self.sample_params()
        if not any_transform:
            return scan, seg
        return native.warp_augment2d_int16(scan, seg, affine)
