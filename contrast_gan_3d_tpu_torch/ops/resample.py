"""Point samplers for the spatial augmentation, the world-patch sampler and
the whole-volume resampler (counterpart of
``contrast_gan_3d_tpu/ops/resample.py``).

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

``trilinear_sample_extrapolate`` is the host geometry engine's
``trilinear_interpolate`` (the reference ``fast_trilinear``) on the device:
the base index truncates toward zero, the +1 neighbour clips on its own
and the fraction is not clamped, so :func:`sample_world_patch` cuts the
same ostia patches as ``utils/geometry.extract_ostia_patch``.

``make_volume_resampler`` / ``resample_volume`` change a volume's spacing
as three separable dense contractions, one (n_out, n_in) interpolation
matrix per axis (clamp-to-edge linear, or nearest), with the grid
convention of the JAX package: output voxel i sits at input index
i * out_spacing / in_spacing and the output covers the input's extent,
n_out = round(n_in * in_spacing / out_spacing). int16 volumes come back
rounded half to even and clipped to int16; floats stay floats. The
contractions run in full f32 (``utils/device.full_f32``): a TF32
interpolation weight would round thousands of int16 voxels the other way.
"""

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from contrast_gan_3d_tpu_torch.utils.device import full_f32, resolve_device


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


def _lerp8(flat, base, dims, corners, fracs) -> torch.Tensor:
    """The 8-corner trilinear blend, in the JAX ``_lerp8`` order: one flat
    gather per corner. Only the callers' corners and fractions differ."""
    (x0, x1), (y0, y1), (z0, z1) = corners
    fx, fy, fz = fracs
    _, _, Y, Z = dims

    def gather(ix, iy, iz):
        return flat[base + (ix * Y + iy) * Z + iz]

    return (
        gather(x0, y0, z0) * (1 - fx) * (1 - fy) * (1 - fz)
        + gather(x1, y0, z0) * fx * (1 - fy) * (1 - fz)
        + gather(x0, y1, z0) * (1 - fx) * fy * (1 - fz)
        + gather(x0, y0, z1) * (1 - fx) * (1 - fy) * fz
        + gather(x1, y1, z0) * fx * fy * (1 - fz)
        + gather(x1, y0, z1) * fx * (1 - fy) * fz
        + gather(x0, y1, z1) * (1 - fx) * fy * fz
        + gather(x1, y1, z1) * fx * fy * fz
    )


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
    out = _lerp8(flat, base, dims, corners, fracs)
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


def trilinear_sample_extrapolate(volume: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Trilinear samples of each volume at its (B, ..., 3) coords with the
    reference ``fast_trilinear`` semantics (truncated base, independently
    clipped +1 neighbour, unclamped fraction): (B, ...) or (B, ..., C)."""
    flat, dims, has_channels = _flat(volume)
    base = _batch_base(coords, dims)
    corners, fracs = [], []
    for axis, n in enumerate(dims[1:]):
        x = coords[..., axis]
        i0p = x.long()  # truncates toward zero
        i0 = i0p.clamp(0, n - 1)
        corners.append((i0, (i0p + 1).clamp(0, n - 1)))
        fracs.append((x - i0).unsqueeze(-1))
    out = _lerp8(flat, base, dims, corners, fracs)
    return out if has_channels else out[..., 0]


def sample_world_patch(volume: torch.Tensor, centers_world, image_spacing, patch_size: Sequence[int],
                       patch_spacing) -> torch.Tensor:
    """Axis-aligned ``patch_size`` patches of the (X, Y, Z) ``volume``
    centred at the (..., 3) ``centers_world`` (mm from the image origin),
    sampled every ``patch_spacing`` mm: (..., *patch_size) f32 on the
    volume's device, the device counterpart of
    ``utils/geometry.sample_world_patch`` (one patch per centre)."""
    dev = volume.device
    f32 = dict(dtype=torch.float32, device=dev)
    centers = torch.as_tensor(np.asarray(centers_world, np.float32), device=dev)
    lead = centers.shape[:-1]
    grid = identity_grid(tuple(patch_size), device=dev)  # (px, py, pz, 3)
    margin = (torch.as_tensor(tuple(patch_size), **f32) - 1.0) / 2.0
    offsets = (grid - margin) * torch.as_tensor(np.asarray(patch_spacing, np.float32), device=dev)
    coords = (centers.reshape(-1, 1, 1, 1, 3) + offsets) / torch.as_tensor(np.asarray(image_spacing, np.float32),
                                                                          device=dev)
    out = trilinear_sample_extrapolate(volume.to(torch.float32)[None], coords.reshape(1, -1, 3))
    return out.reshape(*lead, *patch_size)


def resample_axis_matrix(n_in: int, n_out: int, step: float, method: str = "linear") -> np.ndarray:
    """(n_out, n_in) f32 interpolation matrix for input coordinates x_i =
    i * step: ``linear`` lerps with clamped edges (at most 2 taps per row,
    rows summing to 1); ``nearest`` takes one tap at floor(x + 0.5) and
    keeps masks binary."""
    x = np.arange(n_out, dtype=np.float64) * float(step)
    mat = np.zeros((n_out, n_in), dtype=np.float32)
    rows = np.arange(n_out)
    if method == "nearest":
        mat[rows, np.clip(np.floor(x + 0.5).astype(np.int64), 0, n_in - 1)] = 1.0
        return mat
    if method != "linear":
        raise ValueError(f"unknown resample method: {method!r}")
    j0 = np.clip(np.floor(x).astype(np.int64), 0, n_in - 1)
    j1 = np.minimum(j0 + 1, n_in - 1)
    f = np.clip(x - j0, 0.0, 1.0)
    mat[rows, j0] += (1.0 - f).astype(np.float32)
    mat[rows, j1] += f.astype(np.float32)
    return mat


def resample_output_shape(in_shape, in_spacing, out_spacing) -> Tuple[int, ...]:
    """The output grid covering the input's physical extent at
    ``out_spacing``: round(n * in / out) per axis, at least 1."""
    n_in = np.asarray(in_shape, dtype=np.float64)
    s_in = np.broadcast_to(np.asarray(in_spacing, np.float64), n_in.shape)
    s_out = np.broadcast_to(np.asarray(out_spacing, np.float64), n_in.shape)
    return tuple(int(max(1, round(n * si / so))) for n, si, so in zip(n_in, s_in, s_out))


def make_volume_resampler(in_shape: Tuple[int, ...], in_spacing, out_spacing,
                          out_shape: Optional[Tuple[int, ...]] = None, method: str = "linear", device="cuda"):
    """``(fn, out_shape)``: ``fn(volume)`` resamples a tensor on ``device``
    whose leading ``len(in_shape)`` dims are spatial (2D or 3D; trailing
    channel dims pass through). int16 in, int16 out (rounded half to even,
    clipped); float in, the same float out."""
    device = resolve_device(device)
    ndim = len(in_shape)
    if out_shape is None:
        out_shape = resample_output_shape(in_shape, in_spacing, out_spacing)
    s_in = np.broadcast_to(np.asarray(in_spacing, np.float64), (ndim,))
    s_out = np.broadcast_to(np.asarray(out_spacing, np.float64), (ndim,))
    mats = [torch.as_tensor(resample_axis_matrix(int(n), int(m), so / si, method=method), device=device)
            for n, m, si, so in zip(in_shape, out_shape, s_in, s_out)]

    def fn(volume: torch.Tensor) -> torch.Tensor:
        in_dtype = volume.dtype
        vol = volume.to(torch.float32)
        with full_f32():
            for axis, mat in enumerate(mats):
                vol = torch.movedim(torch.tensordot(mat, vol, dims=([1], [axis])), 0, axis)
        if not in_dtype.is_floating_point:
            info = torch.iinfo(in_dtype)
            vol = torch.round(vol).clamp_(info.min, info.max)
        return vol.to(in_dtype)

    return fn, tuple(int(m) for m in out_shape)


def resample_volume(volume, in_spacing, out_spacing, out_shape: Optional[Tuple[int, ...]] = None,
                    method: str = "linear", spatial_dims: Optional[int] = None, device="cuda") -> np.ndarray:
    """Resample a host volume ((W, H, D[, C]) or (W, H[, C])) to
    ``out_spacing`` on ``device`` (the card unless the caller names the
    CPU); returns host numpy. The spatial rank is ``spatial_dims`` when
    given, else the length of the broadcast spacings; with scalar spacings
    the first min(ndim, 3) dims are spatial, so a (W, H, C) slice with
    channels needs ``spatial_dims=2``."""
    spatial = max(len(np.atleast_1d(in_spacing)), len(np.atleast_1d(out_spacing)))
    if spatial_dims is not None:
        spatial = int(spatial_dims)
    elif spatial == 1:
        spatial = min(volume.ndim, 3)
    device = resolve_device(device)
    fn, _ = make_volume_resampler(volume.shape[:spatial], in_spacing, out_spacing, out_shape=out_shape,
                                  method=method, device=device)
    return fn(torch.as_tensor(np.ascontiguousarray(volume)).to(device)).cpu().numpy()
