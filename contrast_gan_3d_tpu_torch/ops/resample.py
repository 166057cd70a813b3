"""Point samplers for the spatial augmentation (counterpart of the 3D and
2D parts of ``contrast_gan_3d_tpu/ops/resample.py``).

``trilinear_sample`` is true clamp-to-edge: clamped integer corners, the
fraction against the clamped base clamped to [0, 1], eight gathers by flat
index, blended in the JAX ``_lerp8`` order. ``nearest_sample`` rounds half
to even (``torch.round``, like ``jnp.round`` and the JAX package's native
host warp). Neither goes through ``F.grid_sample``: its normalisation to
[-1, 1] and back moves coordinates by rounding, which flips the nearest
mask voxel at half-integer coordinates.

Every sampler takes a batch: ``volume`` (B, X, Y, Z) or (B, X, Y, Z, C)
and ``coords`` (B, ..., 3) in voxel units; sample b reads volume b. The 2D
samplers (``bilinear_sample``, ``nearest_sample_2d``) take (B, X, Y) or
(B, X, Y, C) images and (B, ..., 2) coordinates, with the same
conventions: clamped corners, ``f = clip(x - floor_clamped(x), 0, 1)``,
half-to-even rounding.
``resize_weights`` is ``jax.image.resize``'s linear (triangle) kernel as a
(n_in, n_out) matrix, antialiased on shrinking axes as JAX does.
"""

from typing import Sequence

import torch


def identity_grid(shape: Sequence[int], device=None) -> torch.Tensor:
    """(*shape, len(shape)) f32 grid of voxel coordinates: (X, Y, Z, 3),
    or (X, Y, 2) for a slice."""
    axes = [torch.arange(s, dtype=torch.float32, device=device) for s in shape]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)


def rotation_matrix(angles: torch.Tensor) -> torch.Tensor:
    """(..., 3) per-axis angles in radians -> (..., 3, 3) rotations
    Rz @ Ry @ Rx."""
    c, s = torch.cos(angles), torch.sin(angles)
    one, zero = torch.ones_like(c[..., 0]), torch.zeros_like(c[..., 0])

    def mat(*rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    cx, cy, cz, sx, sy, sz = c[..., 0], c[..., 1], c[..., 2], s[..., 0], s[..., 1], s[..., 2]
    rx = mat((one, zero, zero), (zero, cx, -sx), (zero, sx, cx))
    ry = mat((cy, zero, sy), (zero, one, zero), (-sy, zero, cy))
    rz = mat((cz, -sz, zero), (sz, cz, zero), (zero, zero, one))
    return rz @ ry @ rx


def _flat(volume: torch.Tensor):
    """(B, X, Y, Z[, C]) -> ((B*X*Y*Z, C) view, (B, X, Y, Z), has_channels)."""
    has_channels = volume.dim() == 5
    if not has_channels:
        volume = volume.unsqueeze(-1)
    B, X, Y, Z, C = volume.shape
    return volume.reshape(-1, C), (B, X, Y, Z), has_channels


def _batch_base(coords: torch.Tensor, dims) -> torch.Tensor:
    """Sample b's offset into the flat batch, broadcast against coords[..., 0]."""
    B, X, Y, Z = dims
    base = torch.arange(B, device=coords.device) * (X * Y * Z)
    return base.reshape((B,) + (1,) * (coords.dim() - 2))


def trilinear_sample(volume: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Clamp-to-edge trilinear samples of each volume at its (B, ..., 3)
    coords: (B, ...) or (B, ..., C)."""
    flat, dims, has_channels = _flat(volume)
    base = _batch_base(coords, dims)
    corners, fracs = [], []
    for axis, n in enumerate(dims[1:]):
        x = coords[..., axis]
        i0 = torch.floor(x).long().clamp(0, n - 1)
        corners.append((i0, torch.clamp(i0 + 1, max=n - 1)))
        fracs.append(torch.clamp(x - i0, 0.0, 1.0).unsqueeze(-1))
    (x0, x1), (y0, y1), (z0, z1) = corners
    fx, fy, fz = fracs
    _, _, Y, Z = dims

    def gather(ix, iy, iz):
        return flat[base + (ix * Y + iy) * Z + iz]

    out = (
        gather(x0, y0, z0) * (1 - fx) * (1 - fy) * (1 - fz)
        + gather(x1, y0, z0) * fx * (1 - fy) * (1 - fz)
        + gather(x0, y1, z0) * (1 - fx) * fy * (1 - fz)
        + gather(x0, y0, z1) * (1 - fx) * (1 - fy) * fz
        + gather(x1, y1, z0) * fx * fy * (1 - fz)
        + gather(x1, y0, z1) * fx * (1 - fy) * fz
        + gather(x0, y1, z1) * (1 - fx) * fy * fz
        + gather(x1, y1, z1) * fx * fy * fz
    )
    return out if has_channels else out[..., 0]


def nearest_sample(volume: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour samples (segmentation masks), half to even,
    clamped to the volume."""
    flat, dims, has_channels = _flat(volume)
    _, X, Y, Z = dims
    ix, iy, iz = (torch.round(coords[..., a]).long().clamp(0, n - 1) for a, n in enumerate((X, Y, Z)))
    out = flat[_batch_base(coords, dims) + (ix * Y + iy) * Z + iz]
    return out if has_channels else out[..., 0]


def resize_weights(n_in: int, n_out: int, antialias: bool = True, device=None) -> torch.Tensor:
    """(n_in, n_out) f32 weights of ``jax.image.resize(method="linear")``
    along one axis (``jax._src.image.scale.compute_weight_mat``): the
    triangle kernel at the half-pixel sample points, widened by
    n_in / n_out on a shrinking axis when ``antialias``, each column
    normalised to sum 1. ``antialias=False`` is plain half-pixel linear
    interpolation with clamped edges (the JAX package's native host warp)."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample_f = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]).abs() / kernel_scale
    w = torch.clamp(1 - x, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_linear(x: torch.Tensor, shape: Sequence[int], antialias: bool = True) -> torch.Tensor:
    """Resize dims 1..3 of (B, X, Y, Z, C) ``x`` to ``shape`` with
    :func:`resize_weights`; an axis whose size does not change is left as
    it is (``jax.image.resize`` skips it too)."""
    for axis, n_out in enumerate(shape, start=1):
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        w = resize_weights(n_in, n_out, antialias, device=x.device).to(x.dtype)
        x = torch.movedim(torch.tensordot(x, w, dims=([axis], [0])), -1, axis)
    return x


def _flat_2d(image: torch.Tensor):
    """(B, X, Y[, C]) -> ((B*X*Y, C) view, (B, X, Y), has_channels)."""
    has_channels = image.dim() == 4
    if not has_channels:
        image = image.unsqueeze(-1)
    B, X, Y, C = image.shape
    return image.reshape(-1, C), (B, X, Y), has_channels


def bilinear_sample(image: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Clamp-to-edge bilinear samples of each image at its (B, ..., 2)
    coords, blended in the JAX ``bilinear_sample`` order."""
    flat, (B, X, Y), has_channels = _flat_2d(image)
    base = (torch.arange(B, device=coords.device) * (X * Y)).reshape((B,) + (1,) * (coords.dim() - 2))
    corners, fracs = [], []
    for axis, n in enumerate((X, Y)):
        x = coords[..., axis]
        i0 = torch.floor(x).long().clamp(0, n - 1)
        corners.append((i0, torch.clamp(i0 + 1, max=n - 1)))
        fracs.append(torch.clamp(x - i0, 0.0, 1.0).unsqueeze(-1))
    (x0, x1), (y0, y1) = corners
    fx, fy = fracs

    def gather(ix, iy):
        return flat[base + ix * Y + iy]

    out = (
        gather(x0, y0) * (1 - fx) * (1 - fy)
        + gather(x1, y0) * fx * (1 - fy)
        + gather(x0, y1) * (1 - fx) * fy
        + gather(x1, y1) * fx * fy
    )
    return out if has_channels else out[..., 0]


def nearest_sample_2d(image: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour samples of each image (masks), half to even,
    clamped to the image."""
    flat, (B, X, Y), has_channels = _flat_2d(image)
    base = (torch.arange(B, device=coords.device) * (X * Y)).reshape((B,) + (1,) * (coords.dim() - 2))
    ix, iy = (torch.round(coords[..., a]).long().clamp(0, n - 1) for a, n in enumerate((X, Y)))
    out = flat[base + ix * Y + iy]
    return out if has_channels else out[..., 0]
