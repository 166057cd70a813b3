"""What the patch sampler needs of ``contrast_gan_3d_tpu/utils/geometry.py``
(the port's own copy): world -> voxel coordinates and clamped patch
bounds."""

from typing import Sequence, Tuple

import numpy as np


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
