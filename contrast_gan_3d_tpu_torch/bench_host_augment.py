"""The host augmentation ceiling: how many patches (slices) per second the
host can crop and warp, against what the train step consumes (the port's
counterpart of the JAX package's ``scripts/bench_host_augment.py``):

    python -m contrast_gan_3d_tpu_torch.bench_host_augment                 # 128^3, held against the card
    python -m contrast_gan_3d_tpu_torch.bench_host_augment --patch 16 --reps 1 --device cpu

On this host, through the port's native library (``native/``, built at
first use; a failed build raises, nothing falls back) and
``data/host_augment.HostAugmenter`` / ``HostAugmenter2D``:
- the 3D warp with every transform firing (rotation, scale and elastic:
  the worst case) and its OpenMP thread count;
- the effective augmentation cost at the reference probabilities (elastic
  p=.1, scale p=.2, rotation p=.2; about 58% of the patches skip the
  warp), averaged over 40 draws;
- the native crop (``crop_pad_int16``) of one patch;
- the sustained patches/s of crop + effective augmentation, against
  ``--consumption`` patches/s;
- the 2D warp (the conf_2d family) with rotation and mirroring always on,
  per 2D slice, and the sustained slices/s against ``--consumption-2d``.

The consumption defaults are the card's train rates (PERF.md section 5,
NVIDIA H100 80GB HBM3 at a 700 W power limit, ``chip_smoke.py``'s cycle
phase): ``basic_3d``'s packed bf16 replayed cycle, 0.2802 s per 5
iterations of 6 + 3 + 3 patches (214.1 patches/s), and ``conf_2d``'s,
0.1486 s per 5 iterations of 256 + 128 + 128 slices (17227.5 slices/s).
``--device`` names the card whose train step the figures stand for; it
defaults to cuda and raises without one (``--device cpu`` times the same
host work against the same defaults).

Prints one JSON object on stdout; logs go to stderr.
"""

import argparse
import json
import sys
import time

import numpy as np

from contrast_gan_3d_tpu_torch import native
from contrast_gan_3d_tpu_torch.data.augment import Augment2DConfig, AugmentConfig
from contrast_gan_3d_tpu_torch.data.host_augment import HostAugmenter, HostAugmenter2D
from contrast_gan_3d_tpu_torch.utils.device import resolve_device
from contrast_gan_3d_tpu_torch.utils.logging_utils import create_logger, project_logs_to_stderr

LOGGER = "contrast_gan_3d_tpu_torch.bench_host_augment"
# the card's consumption (PERF.md section 5: replayed cycles of 5
# iterations on an NVIDIA H100 80GB HBM3 at 700 W)
CONSUMPTION_3D = 5 * (6 + 3 + 3) / 0.2802
CONSUMPTION_2D = 5 * (256 + 128 + 128) / 0.1486
EFFECTIVE_DRAWS = 40
SLICES_2D = 400


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--patch", type=int, default=128, help="the patch's (slice's) edge")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--consumption", type=float, default=CONSUMPTION_3D,
                   help="patches/s the 3D train step consumes (default: basic_3d's packed bf16 replayed cycle "
                        "on an NVIDIA H100 80GB HBM3 at 700 W, %(default).1f)")
    p.add_argument("--consumption-2d", type=float, default=CONSUMPTION_2D,
                   help="slices/s the 2D train step consumes (default: conf_2d's replayed cycle on an NVIDIA "
                        "H100 80GB HBM3 at 700 W, %(default).1f)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu: the device whose train step consumes")
    return p.parse_args(argv)


def _best(fn, reps: int) -> float:
    """The least of ``reps`` timed calls after one warm call, seconds."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def measure(patch: int = 128, reps: int = 10, consumption: float = CONSUMPTION_3D,
            consumption_2d: float = CONSUMPTION_2D) -> dict:
    """The ceiling's ten figures (the JAX tool's keys)."""
    n = patch
    rng = np.random.default_rng(0)
    scan = rng.integers(-1024, 1500, (n, n, n), dtype=np.int16)
    seg = (rng.random((n, n, n)) < 0.001).astype(np.int16)

    # worst case: every transform fires
    always = HostAugmenter(AugmentConfig(p_elastic=1.0, p_scale=1.0, p_rotation=1.0), np.random.default_rng(1))
    warp_s = _best(lambda: always(scan, seg), reps)

    # the reference probabilities, averaged over many draws
    default = HostAugmenter(AugmentConfig(), np.random.default_rng(2))
    t0 = time.perf_counter()
    for _ in range(EFFECTIVE_DRAWS):
        default(scan, seg)
    eff_s = (time.perf_counter() - t0) / EFFECTIVE_DRAWS

    vol = rng.integers(-1024, 1500, (192, 192, 160, 2), dtype=np.int16)
    crop_s = _best(lambda: native.crop_pad_int16(vol, (10, 20, 5), (n, n, n)), reps)

    # the 2D warp (conf_2d family): every slice rotated and mirrored
    sl = rng.integers(-1024, 1500, (n, n), dtype=np.int16)
    sl_seg = (rng.random((n, n)) < 0.001).astype(np.int16)
    always2d = HostAugmenter2D(Augment2DConfig(p_rotation=1.0, p_mirror=1.0), np.random.default_rng(3))
    always2d(sl, sl_seg)
    t0 = time.perf_counter()
    for _ in range(SLICES_2D):
        always2d(sl, sl_seg)
    warp2d_s = (time.perf_counter() - t0) / SLICES_2D

    sustained = 1.0 / (eff_s + crop_s)
    return {
        "warp_threads": native.warp_num_threads(),
        "warp_ms_always_on": round(warp_s * 1e3, 2),
        "augment_ms_effective": round(eff_s * 1e3, 2),
        "crop_ms": round(crop_s * 1e3, 2),
        "sustained_patches_per_sec": round(sustained, 2),
        "consumption_patches_per_sec": consumption,
        "feeds_train_step": bool(sustained >= consumption),
        "warp2d_us_always_on": round(warp2d_s * 1e6, 1),
        "sustained_2d_slices_per_sec": round(1.0 / warp2d_s, 0),
        "feeds_2d_train_step": bool(1.0 / warp2d_s >= consumption_2d),
    }


def main(argv=None) -> dict:
    """Run the command in-process; prints and returns the figures."""
    args = parse_args(argv)
    project_logs_to_stderr()
    logger = create_logger(LOGGER)
    device = resolve_device(args.device)
    logger.info("host ceiling at %d^3 against %.1f patches/s and %.1f slices/s (the train step on %s)",
                args.patch, args.consumption, args.consumption_2d, device)
    out = measure(args.patch, args.reps, args.consumption, args.consumption_2d)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
