"""Sliding-window full-volume correction with Gaussian patch blending
(counterpart of ``contrast_gan_3d_tpu/ops/sliding_window.py``).

The volume lives on the device; patches are gathered in batches, run
through the generator, and their attenuation is accumulated with Gaussian
weights; the corrected volume is ``volume - sum(w * atten) / sum(w)``, so a
zero generator is the exact identity and blending never touches raw HU.
The JAX package's ``lax.scan`` over full batches plus one remainder batch
is a Python loop here, and its ``fori_loop`` scatter is a sequence of
in-place adds in the same order (so the f32 sums agree).

``packed_io=True`` runs the loop in block space (``ops/packed.py``): the
volume is edge-padded to a multiple of 4 (and at least the patch) and
packed f=2 once, patches are gathered as block slices, the generator
takes f2-packed patches and returns the f4-packed attenuation, and the
blend accumulates into an f4-packed f32 accumulator. Strides snap down to
multiples of 4, so the grid, and with it the result, differs from the
direct layout's wherever a stride or a dim is not a multiple of 4, as in
the JAX package.
"""

from functools import lru_cache
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from contrast_gan_3d_tpu_torch.data.scaler import FactorZeroCenterScaler, Scaler
from contrast_gan_3d_tpu_torch.ops.resample import resize_linear
from contrast_gan_3d_tpu_torch.ops.s2d_conv import depth_to_space, space_to_depth
from contrast_gan_3d_tpu_torch.utils.device import resolve_device
from contrast_gan_3d_tpu_torch.utils.spans import span


@lru_cache(maxsize=32)
def weight_vectors(
    padded_shape: Tuple[int, ...],
    patch_size: Tuple[int, ...],
    stride: Tuple[int, ...],
    sigma_scale: float,
) -> Tuple[np.ndarray, ...]:
    """Per-axis window-sum vectors whose outer product is the blending
    normalization field sum_patches(window): the patch grid is a Cartesian
    product of per-axis starts and the window a product of per-axis
    Gaussians, so the field separates exactly."""
    vecs = []
    for dim, p, s in zip(padded_shape, patch_size, stride):
        g = gaussian_weights_1d(p, sigma_scale)
        acc = np.zeros(dim, np.float64)
        for start in grid_starts(dim, p, s):
            acc[start : start + p] += g
        vecs.append(acc.astype(np.float32))
    return tuple(vecs)


def weight_field(weight_vecs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Outer product of the per-axis vectors (multiplied in axis order, as
    the JAX version)."""
    n = len(weight_vecs)
    out = 1.0
    for i, v in enumerate(weight_vecs):
        shape = [1] * n
        shape[i] = -1
        out = out * v.reshape(shape)
    return out


def grid_starts(dim: int, patch: int, stride: int) -> List[int]:
    """Start offsets covering [0, dim) with a final clamped-to-edge window."""
    if dim <= patch:
        return [0]
    starts = list(range(0, dim - patch, stride))
    starts.append(dim - patch)
    return starts


def gaussian_weights_1d(p: int, sigma_scale: float = 0.125) -> np.ndarray:
    """One axis of the blending window: peak-normalized Gaussian, floored at
    1e-2 per axis (the 3-D product floors at 1e-6 and stays separable)."""
    center = (p - 1) / 2.0
    sigma = max(p * sigma_scale, 1e-8)
    x = np.arange(p, dtype=np.float64)
    g = np.exp(-0.5 * ((x - center) / sigma) ** 2)
    return np.maximum(g / g.max(), 1e-2)


def gaussian_weights(patch_size: Sequence[int], sigma_scale: float = 0.125) -> np.ndarray:
    """Separable Gaussian blending window (product of per-axis windows)."""
    ws = [gaussian_weights_1d(p, sigma_scale) for p in patch_size]
    w = ws[0]
    for g in ws[1:]:
        w = w[..., None] * g
    return w.astype(np.float32)


def plan_stride(
    patch_size: Sequence[int], overlap: float, packed_io: bool
) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(patch_size, stride): stride = round(p * (1 - overlap)); packed grids
    additionally require patch % 4 == 0 and snap strides DOWN to multiples
    of 4 (never less overlap than requested)."""
    patch_size = tuple(int(p) for p in patch_size)
    stride = tuple(max(1, int(round(p * (1.0 - overlap)))) for p in patch_size)
    if packed_io:
        if any(p % 4 for p in patch_size):
            raise ValueError(f"packed_io requires patch_size % 4 == 0, got {patch_size}")
        if any(s < 4 for s in stride):
            raise ValueError(
                f"packed_io needs stride >= 4 (got {stride}): overlap "
                f"{overlap} is too extreme for block-aligned gathers — use "
                "the direct corrector"
            )
        stride = tuple(s - s % 4 for s in stride)
    return patch_size, stride


def _plan_grid(
    shape: Tuple[int, int, int], patch_size: Tuple[int, int, int], stride: Tuple[int, int, int]
) -> np.ndarray:
    """(N, 3) int array of patch start corners covering ``shape``."""
    axes = [grid_starts(shape[i], patch_size[i], stride[i]) for i in range(3)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    return grid.astype(np.int64)


def num_patches(
    shape: Sequence[int],
    patch_size: Sequence[int],
    overlap: float = 0.5,
    packed_io: bool = False,
) -> int:
    """Patch count the corrector runs for a volume shape (``packed_io``
    counts the JAX package's block-aligned grid)."""
    stride = [max(1, int(round(p * (1.0 - overlap)))) for p in patch_size]
    padded = [max(s, p) for s, p in zip(shape, patch_size)]
    if packed_io:
        if any(s < 4 for s in stride):
            raise ValueError(
                f"packed_io needs stride >= 4 (got {tuple(stride)}): overlap "
                f"{overlap} is too high for patch {tuple(patch_size)}"
            )
        stride = [s - s % 4 for s in stride]
        padded = [d + ((-d) % 4) for d in padded]
    return int(
        np.prod([len(grid_starts(padded[i], patch_size[i], stride[i])) for i in range(3)])
    )


def make_direct_patch_loop(vol, patch_size, gw, generator_apply, dtype):
    """The direct layout's gather / forward / scatter over one batch of
    start corners: ``run_batch(acc, starts, valid=None)``; ``valid`` is a
    per-patch 0/1 weight vector for grids padded to uniform batches (the
    sharded corrector)."""

    def run_batch(acc, starts, valid=None):
        with span("correct.gather"):
            patches = torch.stack([
                vol[x : x + patch_size[0], y : y + patch_size[1], z : z + patch_size[2]]
                for x, y, z in starts
            ])
        atten = generator_apply(patches[:, None].to(dtype))[:, 0]
        if tuple(atten.shape[1:]) != patch_size:
            # a patch the generator does not divide: its output is
            # ceil-rounded, resized back in the generator's dtype before the
            # f32 cast, as jax.image.resize(method="trilinear") does in JAX
            atten = resize_linear(atten[..., None], patch_size)[..., 0]
        with span("correct.accumulate"):
            atten = atten.float()
            for i, (x, y, z) in enumerate(starts):
                w = gw if valid is None else gw * float(valid[i])
                acc[x : x + patch_size[0], y : y + patch_size[1], z : z + patch_size[2]] += atten[i] * w

    return run_batch


def make_packed_patch_loop(vp, patch_size, gw_p, generator_apply):
    """Block-space counterpart of :func:`make_direct_patch_loop`: ``vp`` is
    the f2-packed volume, ``generator_apply`` takes f2-packed patches
    (B, p/2, p/2, p/2, 8) and returns the f4-packed attenuation (B, p/4,
    p/4, p/4, 64), and the accumulator and window ``gw_p`` are f4-packed.
    Every start is a multiple of 4. ``valid`` as in
    :func:`make_direct_patch_loop`."""
    p2 = tuple(p // 2 for p in patch_size)
    p4 = tuple(p // 4 for p in patch_size)

    def run_batch(acc, starts, valid=None):
        with span("correct.gather"):
            patches = torch.stack([
                vp[x // 2 : x // 2 + p2[0], y // 2 : y // 2 + p2[1], z // 2 : z // 2 + p2[2]]
                for x, y, z in starts
            ])
        atten = generator_apply(patches)
        with span("correct.accumulate"):
            atten = atten.float()
            for i, (x, y, z) in enumerate(starts):
                w = gw_p if valid is None else gw_p * float(valid[i])
                acc[x // 4 : x // 4 + p4[0], y // 4 : y // 4 + p4[1], z // 4 : z // 4 + p4[2]] += atten[i] * w

    return run_batch


def count_batch(counts: Optional[dict], samples: int, useful: int) -> None:
    """Add one generator batch of ``samples`` windows or slices, ``useful``
    of which land in the volume (the rest: padding), to a corrector's
    ``counts`` (``batches``, ``samples``, ``useful``); None counts nothing."""
    if counts is not None:
        counts["batches"] += 1
        counts["samples"] += samples
        counts["useful"] += useful


def scan_patch_batches_masked(run_batch, acc, starts_b, valid_b):
    """The masked grid (the sharded corrector): uniform batches of starts,
    each with its per-patch 0/1 validity vector, in order (the JAX
    ``scan_patch_batches_masked``). Returns ``acc``."""
    for starts, valid in zip(starts_b, valid_b):
        run_batch(acc, starts, valid)
    return acc


def packed_padded_shape(shape, patch_size) -> Tuple[int, int, int]:
    """The packed corrector's padded volume: at least the patch on every
    axis and a multiple of 4 (a block-aligned grid)."""
    return tuple(-(-max(s, p) // 4) * 4 for s, p in zip(shape, patch_size))


def make_volume_corrector(
    generator_apply: Callable[[torch.Tensor], torch.Tensor],
    patch_size: Tuple[int, int, int] = (128, 128, 128),
    overlap: float = 0.5,
    batch_size: int = 4,
    scaler: Scaler = FactorZeroCenterScaler(),
    sigma_scale: float = 0.125,
    device="cuda",
    dtype: torch.dtype = torch.float32,
    packed_io: bool = False,
    counts: Optional[dict] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build ``correct(volume) -> corrected_volume`` on ``device``.

    ``generator_apply``: (B, 1, *patch) scaled patches in ``dtype`` ->
    (B, 1, *patch) attenuation in (-1, 1), on ``device``; with
    ``packed_io`` the f2-packed patches -> the f4-packed attenuation
    (``ResnetGenerator.forward_packed(x, True, True)``). The attenuation is
    cast to f32 before the blend. ``volume``: a (W, H, D) HU array or
    tensor (int16/float), scaled in f32; the result is an f32 HU tensor on
    ``device``. Patch sizes must divide 4 with ``packed_io``. In the direct
    layout a patch size the generator does not divide gives a ceil-rounded
    attenuation, resized back to the patch (``resample.resize_linear``,
    antialiased when it shrinks). ``counts``: a dict whose ``batches``,
    ``samples`` and ``useful`` each batch adds to (:func:`count_batch`).
    Spans under a running profiler (``utils/spans.py``): ``correct.h2d``
    (the volume to the device in f32), ``correct.prepare`` (scale, pad,
    pack, plan), ``correct.batch`` per batch (``correct.gather``, the
    generator's ``gen.*``, ``correct.accumulate``), ``correct.blend``
    (unpack, normalise, crop, unscale).
    """
    device = resolve_device(device)
    patch_size, stride = plan_stride(patch_size, overlap, packed_io)
    gw = torch.as_tensor(gaussian_weights(patch_size, sigma_scale), device=device)
    if packed_io:
        gw_p = space_to_depth(gw[None, ..., None], 4)[0]  # (*p/4, 64)

    def correct(volume) -> torch.Tensor:
        """Correct one (W, H, D) HU volume; returns an f32 HU volume."""
        volume = torch.as_tensor(volume)
        shape = tuple(volume.shape)
        with span("correct.h2d"):
            vol = volume.to(device=device, dtype=torch.float32)
        with span("correct.prepare"):
            # pad (centered, edge values) dims smaller than the patch;
            # packed: also up to a multiple of 4
            target = packed_padded_shape(shape, patch_size) if packed_io else \
                tuple(max(s, p) for s, p in zip(shape, patch_size))
            pad_cfg = [((t - s) // 2, (t - s) - (t - s) // 2) for s, t in zip(shape, target)]
            vol = scaler(vol)
            if any(p != (0, 0) for p in pad_cfg):
                flat = [v for lo_hi in reversed(pad_cfg) for v in lo_hi]
                vol = F.pad(vol[None, None], flat, mode="replicate")[0, 0]
            padded_shape = tuple(vol.shape)

            grid = _plan_grid(padded_shape, patch_size, stride).tolist()
            if packed_io:
                # the volume, the window and the accumulator all live packed
                vp = space_to_depth(vol[None, ..., None].to(dtype), 2)[0]
                run_batch = make_packed_patch_loop(vp, patch_size, gw_p, generator_apply)
                acc = torch.zeros((*(d // 4 for d in padded_shape), 64), dtype=torch.float32, device=device)
            else:
                run_batch = make_direct_patch_loop(vol, patch_size, gw, generator_apply, dtype)
                acc = torch.zeros(padded_shape, dtype=torch.float32, device=device)
        # full batches, then the trailing n % batch_size patches as one
        # smaller batch (no zero-weighted padding patches)
        for b0 in range(0, len(grid), batch_size):
            starts = grid[b0 : b0 + batch_size]
            with span("correct.batch"):
                run_batch(acc, starts)
            count_batch(counts, len(starts), len(starts))
        with span("correct.blend"):
            if packed_io:
                acc = depth_to_space(acc[None], 4)[0, ..., 0]
            wvecs = weight_vectors(padded_shape, patch_size, stride, sigma_scale)
            field = weight_field([torch.as_tensor(v, device=device) for v in wvecs])
            corrected = vol - acc / field
            lo = [p[0] for p in pad_cfg]
            corrected = corrected[
                lo[0] : lo[0] + shape[0], lo[1] : lo[1] + shape[1], lo[2] : lo[2] + shape[2]
            ]
            return scaler.unscale(corrected)

    return correct
