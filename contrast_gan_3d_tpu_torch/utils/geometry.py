"""The host geometry engine in numpy (the port's copy of
``contrast_gan_3d_tpu/utils/geometry.py``): world <-> voxel coordinates,
trilinear interpolation with the reference ``fast_trilinear`` semantics,
world-space patches and the ostia patches, clamped patch bounds,
centerline rasterization and pairwise distances. These run on the host
during preprocessing and evaluation; the device resampler is
``ops/resample.py``."""

from typing import Sequence, Tuple

import numpy as np

from contrast_gan_3d_tpu_torch.constants import AORTIC_ROOT_PATCH_SIZE, AORTIC_ROOT_PATCH_SPACING


def deg_to_radians(deg: float) -> float:
    return deg * np.pi / 180.0


def parse_patch_size(patch_size: Sequence[int], source_shape: Sequence[int]) -> np.ndarray:
    """Resolve -1 entries in a patch size to the corresponding source dim."""
    out = np.asarray(patch_size).copy()
    src = np.asarray(source_shape)
    mask = out == -1
    out[mask] = src[: len(out)][mask]
    return out


def world_to_image_coords(world_coords: np.ndarray, offset: np.ndarray, spacing: np.ndarray) -> np.ndarray:
    """World-space (mm) points to integer voxel indices: round((w - o) / s)."""
    world_coords = np.asarray(world_coords)
    if world_coords.shape[-1] != 3:
        raise ValueError(f"expected (..., 3) world coordinates, got {world_coords.shape}")
    return np.round((world_coords - np.asarray(offset)) / np.asarray(spacing)).astype(int)


def image_to_world_coords(image_coords: np.ndarray, offset: np.ndarray, spacing: np.ndarray) -> np.ndarray:
    """Voxel indices to world mm: i * s + o."""
    return np.asarray(image_coords) * np.asarray(spacing) + np.asarray(offset)


def trilinear_interpolate(volume: np.ndarray, xs: np.ndarray, ys: np.ndarray, zs: np.ndarray) -> np.ndarray:
    """Trilinear samples of ``volume`` at fractional voxel coordinates, as
    the reference ``fast_trilinear``: the base index truncates toward zero,
    the +1 neighbour is clipped on its own (not from the clipped base), and
    the fraction against the clipped base is not clamped, so points near
    or beyond the border extrapolate."""
    shape = volume.shape
    base = [np.asarray(c).astype(np.int64) for c in (xs, ys, zs)]
    (x0, y0, z0), (x1, y1, z1) = (
        [np.clip(b + d, 0, n - 1) for b, n in zip(base, shape)] for d in (0, 1)
    )
    fx, fy, fz = xs - x0, ys - y0, zs - z0
    return (
        volume[x0, y0, z0] * (1 - fx) * (1 - fy) * (1 - fz)
        + volume[x1, y0, z0] * fx * (1 - fy) * (1 - fz)
        + volume[x0, y1, z0] * (1 - fx) * fy * (1 - fz)
        + volume[x0, y0, z1] * (1 - fx) * (1 - fy) * fz
        + volume[x1, y1, z0] * fx * fy * (1 - fz)
        + volume[x1, y0, z1] * fx * (1 - fy) * fz
        + volume[x0, y1, z1] * (1 - fx) * fy * fz
        + volume[x1, y1, z1] * fx * fy * fz
    )


def sample_world_patch(volume: np.ndarray, center_world: np.ndarray, image_spacing: np.ndarray,
                       patch_size: np.ndarray, patch_spacing: np.ndarray) -> np.ndarray:
    """An axis-aligned ``patch_size`` patch centred at ``center_world`` (mm
    from the image origin), sampled every ``patch_spacing`` mm with
    :func:`trilinear_interpolate`."""
    patch_size = np.asarray(patch_size)
    margin = (patch_size - 1) / 2.0
    axes = [(center_world[i] + (np.arange(patch_size[i]) - margin[i]) * patch_spacing[i]) / image_spacing[i]
            for i in range(3)]
    xs, ys, zs = np.meshgrid(*axes, indexing="ij")
    return trilinear_interpolate(volume, xs.ravel(), ys.ravel(), zs.ravel()).reshape(tuple(patch_size))


def extract_ostia_patch(scan: np.ndarray, ostia_world: np.ndarray, offset: np.ndarray, spacing: np.ndarray,
                        patch_size: np.ndarray = AORTIC_ROOT_PATCH_SIZE,
                        patch_spacing: np.ndarray = AORTIC_ROOT_PATCH_SPACING) -> np.ndarray:
    """One resampled patch per ostium, stacked: (n_ostia, *patch_size)."""
    return np.stack([
        sample_world_patch(scan, coords, spacing, patch_size, patch_spacing)
        for coords in np.asarray(ostia_world) - np.asarray(offset)
    ])


def ensure_valid_bounds(s: int, e: int, target_size: int, size: int) -> Tuple[int, int]:
    """Shift a [s, e) window so it fits in [0, size); a target larger than
    the source gives the whole source (the caller pads)."""
    if target_size >= size:
        return 0, size
    if s < 0 and e > size:
        raise ValueError(f"window [{s}, {e}) invalid for size {size}")
    if s < 0:
        s, e = 0, target_size
    if e > size:
        s, e = size - target_size, size
    return s, e


def get_patch_bounds(target_shape: Sequence[int], source_shape: Sequence[int], coords: np.ndarray) -> np.ndarray:
    """(ndim, 2) bounding box of ``target_shape`` centred on ``coords``,
    clamped inside ``source_shape`` (-1 target dims resolve to the source
    dim first)."""
    target = parse_patch_size(target_shape, source_shape)
    half = target // 2
    coords = np.asarray(coords)
    bbox = np.stack([coords - half, coords + half + target % 2], axis=-1)
    for i in range(len(bbox)):
        bbox[i] = ensure_valid_bounds(bbox[i, 0], bbox[i, 1], target[i], source_shape[i])
    return bbox


def world_to_grid_coords(points_world: np.ndarray, offset: np.ndarray, spacing: np.ndarray,
                         grid_shape: Sequence[int]) -> np.ndarray:
    """A binary uint8 grid of ``grid_shape`` with a 1 at each world point's
    voxel (rounded, deduplicated, clipped into the grid)."""
    img_coords = np.unique(world_to_image_coords(points_world, offset, spacing), axis=0)
    grid = np.zeros(tuple(grid_shape), dtype=np.uint8)
    grid[tuple(np.clip(img_coords[:, i], 0, grid_shape[i] - 1) for i in range(3))] = 1
    return grid


def grid_to_cartesian_coords(grid_mask: np.ndarray) -> np.ndarray:
    """Indices of the nonzero voxels, (N, ndim)."""
    return np.stack(np.nonzero(grid_mask), axis=-1)


def pointwise_euclidean_distance(centerlines: np.ndarray, annotations: np.ndarray) -> np.ndarray:
    """(X, 3) x (Y, 3) -> (X, Y) pairwise euclidean distances."""
    delta = centerlines[:, None, :] - annotations[None]
    return np.sqrt(np.square(delta).sum(-1))
