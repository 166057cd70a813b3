"""The patch-grid-sharded sliding window over several devices (counterpart
of ``contrast_gan_3d_tpu/parallel/inference.py``).

JAX shards one volume's patch grid over a mesh: every chip holds the
volume and the generator, runs its share of the padded patch batches
through the single-chip loop, and the partial accumulators are summed.
Inference needs no collective here: one process drives a list of devices.
Each device holds a generator replica and the scaled volume, and takes a
contiguous block of the padded patch batches (the share ``shard_map``
gives a chip), the padding patches weighted 0
(``ops/sliding_window.scan_patch_batches_masked``). The devices' batches
are run in turns, so the cards work at once. The partial
accumulators are summed on the first device in device order, then the
Gaussian normalisation and the subtraction run once there.

The grid is the JAX sharded corrector's: the direct layout's is the
single-device corrector's; the packed one pads the patch-padded volume up
to a multiple of 4 at the high end of each axis, where the single-device
packed corrector centres that padding.
"""

import copy
import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from contrast_gan_3d_tpu_torch.data.scaler import FactorZeroCenterScaler, Scaler
from contrast_gan_3d_tpu_torch.ops.s2d_conv import depth_to_space, space_to_depth
from contrast_gan_3d_tpu_torch.ops.sliding_window import (
    _plan_grid,
    count_batch,
    gaussian_weights,
    make_direct_patch_loop,
    make_packed_patch_loop,
    plan_stride,
    scan_patch_batches_masked,
    weight_field,
    weight_vectors,
)
from contrast_gan_3d_tpu_torch.utils.device import resolve_device
from contrast_gan_3d_tpu_torch.utils.spans import span


def local_devices(device: torch.device, n=None) -> list:
    """The devices a command shards over: the first ``n`` cards (None:
    every visible card), or ``n`` shares of the CPU (None: one)."""
    device = torch.device(device)
    if device.type == "cpu":
        return [device] * (n or 1)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count() if n is None else n)]


def replicas(module: torch.nn.Module, devices: Sequence[torch.device]) -> dict:
    """``{device: module on that device}``: ``module`` itself on its own
    device, a deep copy on each other distinct device."""
    home = next(module.parameters()).device
    return {d: module if d == home else copy.deepcopy(module).to(d) for d in dict.fromkeys(devices)}


def make_sharded_volume_corrector(
    generator_apply: Callable[[torch.Tensor, torch.device], torch.Tensor],
    devices: Sequence,
    patch_size: Tuple[int, int, int] = (128, 128, 128),
    overlap: float = 0.5,
    batch_size: int = 4,
    scaler: Scaler = FactorZeroCenterScaler(),
    sigma_scale: float = 0.125,
    dtype: torch.dtype = torch.float32,
    packed_io: bool = False,
    counts: Optional[dict] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build ``correct(volume) -> corrected_volume`` over ``devices`` (a list;
    a device may repeat, e.g. ``["cpu"] * 4``, and then takes as many
    shares). ``generator_apply(patches, device)`` runs the replica on
    ``device``: (B, 1, *patch) -> (B, 1, *patch), or with ``packed_io`` the
    f2-packed patches -> the f4-packed attenuation, as in
    ``ops/sliding_window.make_volume_corrector``. The result is an f32 HU
    tensor on ``devices[0]``. ``counts`` and the spans are those of
    ``make_volume_corrector``; a padding patch is a sample, not a useful
    one."""
    devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("make_sharded_volume_corrector needs at least one device")
    home = devices[0]
    n_dev = len(devices)
    patch_size, stride = plan_stride(patch_size, overlap, packed_io)
    gw_np = gaussian_weights(patch_size, sigma_scale)
    gws = {d: torch.as_tensor(gw_np, device=d) for d in dict.fromkeys(devices)}
    if packed_io:
        gws = {d: space_to_depth(g[None, ..., None], 4)[0] for d, g in gws.items()}

    def correct(volume) -> torch.Tensor:
        """Correct one (W, H, D) HU volume; returns an f32 HU volume."""
        volume = torch.as_tensor(volume)
        shape = tuple(volume.shape)
        with span("correct.h2d"):
            vol = volume.to(device=home, dtype=torch.float32)
        with span("correct.prepare"):
            pad_cfg = []
            for s, p in zip(shape, patch_size):
                lo = max(0, p - s) // 2
                hi = max(0, p - s) - lo
                if packed_io:  # block-aligned dims, the extra rows at the high end
                    hi += (-(s + lo + hi)) % 4
                pad_cfg.append((lo, hi))
            vol = scaler(vol)
            if any(p != (0, 0) for p in pad_cfg):
                flat = [v for lo_hi in reversed(pad_cfg) for v in lo_hi]
                vol = F.pad(vol[None, None], flat, mode="replicate")[0, 0]
            padded_shape = tuple(vol.shape)

            grid = _plan_grid(padded_shape, patch_size, stride)
            n = len(grid)
            n_batches = math.ceil(math.ceil(n / batch_size) / n_dev) * n_dev
            n_padded = n_batches * batch_size
            valid = np.zeros((n_padded,), np.float32)
            valid[:n] = 1.0
            starts = np.concatenate([grid, np.zeros((n_padded - n, 3), np.int64)])
            starts_b = starts.reshape(n_batches, batch_size, 3).tolist()
            valid_b = valid.reshape(n_batches, batch_size).tolist()
            per = n_batches // n_dev

            loops, accs = [], []
            volumes = {}
            for d in devices:
                if d not in volumes:
                    v = vol.to(d)
                    volumes[d] = space_to_depth(v[None, ..., None].to(dtype), 2)[0] if packed_io else v
                apply = lambda x, d=d: generator_apply(x, d)
                if packed_io:
                    loops.append(make_packed_patch_loop(volumes[d], patch_size, gws[d], apply))
                    accs.append(torch.zeros((*(s // 4 for s in padded_shape), 64), dtype=torch.float32, device=d))
                else:
                    loops.append(make_direct_patch_loop(volumes[d], patch_size, gws[d], apply, dtype))
                    accs.append(torch.zeros(padded_shape, dtype=torch.float32, device=d))
        # device k owns batches [k * per, (k + 1) * per); they run in turns
        for j in range(per):
            for k in range(n_dev):
                b = k * per + j
                with span("correct.batch"):
                    scan_patch_batches_masked(loops[k], accs[k], starts_b[b : b + 1], valid_b[b : b + 1])
                count_batch(counts, batch_size, int(sum(valid_b[b])))
        with span("correct.blend"):
            acc = accs[0]
            for other in accs[1:]:
                acc = acc + other.to(home)
            if packed_io:
                acc = depth_to_space(acc[None], 4)[0, ..., 0]
            wvecs = weight_vectors(padded_shape, patch_size, stride, sigma_scale)
            corrected = vol - acc / weight_field([torch.as_tensor(v, device=home) for v in wvecs])
            lo = [p[0] for p in pad_cfg]
            corrected = corrected[lo[0] : lo[0] + shape[0], lo[1] : lo[1] + shape[1], lo[2] : lo[2] + shape[2]]
            return scaler.unscale(corrected)

    return correct
