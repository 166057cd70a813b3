"""Whole volumes corrected one after another, as a cohort is.

Set-up makes the benchmark's generator weights and ``volumes`` distinct
int16 phantoms of ``volume_shape`` from the seed; the BatchNorm running
statistics are the reference's batch statistics over a calibration batch of
the first volume (a trained generator's statistics follow its data, so the
attenuation neither saturates nor vanishes). It builds the generator as
``CCTAContrastCorrector.from_checkpoint`` does (float32) and the corrector
with its defaults for the configuration's patch, corrects one volume to
warm up, and then corrects the host volumes in turn, each copied back to
the host as ``correct_scans`` does before it writes, until the first
completion past ``--seconds``. A sample of ``checked_volumes`` of the
window's results, drawn from the seed, is compared with the reference's
correction of the same volume once the window has closed.

``volumes_per_s``: completed volumes over the time from the first volume's
start to the last completion.
"""

import random
import time

import torch

from benchmark import checks, counts, harness, inputs
from benchmark.measured import Measured
from benchmark.reference import correct as ref_correct
from benchmark.reference import model as ref_model


def calibration_batch(volume: torch.Tensor, patch, n: int) -> torch.Tensor:
    """``n`` scaled patches (3D: windows along the volume's diagonal) or
    slices (2D: evenly spaced along the last axis) of one volume."""
    if len(patch) == 2:
        idx = torch.linspace(0, volume.shape[2] - 1, n).long().tolist()
        return ref_model.scale(volume[:, :, idx].permute(2, 0, 1)).unsqueeze(1)
    out = []
    for k in range(n):
        lo = [int((d - p) * (k + 1) / (n + 1)) for d, p in zip(volume.shape, patch)]
        out.append(volume[lo[0]: lo[0] + patch[0], lo[1]: lo[1] + patch[1], lo[2]: lo[2] + patch[2]])
    return ref_model.scale(torch.stack(out)).unsqueeze(1)


def make_inputs(cfg: dict, mix: dict, seed: int, device) -> tuple:
    """(generator weights, running statistics, host int16 volumes), drawn
    from ``seed`` on ``device``."""
    c, arch = cfg["correct"], cfg["generator"]
    patch = tuple(c["patch"])
    gen = torch.Generator(device=device).manual_seed(seed)
    spec = ref_model.generator_spec(arch["n_resnet_blocks"], arch["n_updownsample_blocks"],
                                    arch["init_channels_out"], len(patch))
    params = ref_model.make_params(spec, gen, device)
    on_device = [inputs.phantoms(gen, 1, tuple(mix["volume_shape"]), mix["hu"], device)[0][0]
                 for _ in range(mix["volumes"])]
    stats = {}
    with torch.no_grad(), harness.full_f32():
        ref_model.generator(params, calibration_batch(on_device[0], patch, mix["calibration"]),
                            arch["n_resnet_blocks"], arch["n_updownsample_blocks"], train=True, stats=stats)
    return params, stats, [v.cpu().numpy() for v in on_device]


def reference(cfg: dict, params: dict, stats: dict, volume: torch.Tensor, prec=None) -> torch.Tensor:
    """The reference's correction of one volume on its device."""
    c, arch = cfg["correct"], cfg["generator"]
    with harness.full_f32():
        if len(c["patch"]) == 2:
            return ref_correct.correct_2d(params, stats, arch, volume, c["reference_batch"], prec=prec)
        return ref_correct.correct_3d(params, stats, arch, volume, tuple(c["patch"]), c["overlap"],
                                      c["reference_batch"], prec=prec)


def run(cfg: dict, mix: dict, seed: int, seconds: float, traced: bool, device: torch.device):
    from contrast_gan_3d_tpu_torch.eval.corrector import CCTAContrastCorrector
    from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator

    c, arch = cfg["correct"], cfg["generator"]
    patch, shape = tuple(c["patch"]), tuple(mix["volume_shape"])
    params, stats, volumes = make_inputs(cfg, mix, seed, device)

    generator = ResnetGenerator(n_resnet_blocks=arch["n_resnet_blocks"],
                                n_updownsample_blocks=arch["n_updownsample_blocks"],
                                init_channels_out=arch["init_channels_out"], ndim=len(patch))
    harness.load_into(generator, params, stats)
    corrector = CCTAContrastCorrector(generator, inference_patch_size=patch, overlap=c["overlap"], device=device)
    stated = {"layout": c["layout"], "batch": c["batch"], "dtype": c["dtype"]}
    resolved = {"layout": "packed" if corrector.packed else "direct", "batch": corrector.batch_size,
                "dtype": str(corrector.dtype).replace("torch.", "")}
    if stated != resolved:
        raise ValueError(f"the corrector resolves to {resolved}, the configuration states {stated}")
    corrector(volumes[0]).cpu()
    harness.sync(device)
    setup_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    # the window
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    draw = random.Random(seed)
    kept = []  # a uniform sample of the window's results: (index, volume, corrected on the host)
    done = 0
    prof, stretch_units, prof_s = None, 0, 0.0

    def one_volume():
        nonlocal done
        which = done % len(volumes)
        with torch.profiler.record_function("bench.correct"):
            out = corrector(volumes[which])
        with torch.profiler.record_function("bench.d2h"):
            host = out.cpu()
        del out
        done += 1
        k = mix["checked_volumes"]
        if len(kept) < k:
            kept.append((done - 1, which, host))
        else:
            slot = draw.randrange(done)
            if slot < k:
                kept[slot] = (done - 1, which, host)

    def stretch():
        for _ in range(mix["profile_volumes"]):
            one_volume()
        return mix["profile_volumes"]

    t0 = time.perf_counter()
    while True:
        if traced and prof is None and time.perf_counter() - t0 >= seconds / 2:
            prof, stretch_units, prof_s = harness.profile_stretch(stretch, device)
        else:
            one_volume()
        # a traced window runs on until its stretch has been profiled
        if time.perf_counter() - t0 >= seconds and (prof is not None or not traced):
            break
    window_s = time.perf_counter() - t0
    window_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    held = torch.cuda.max_memory_reserved(device) if device.type == "cuda" else 0

    # the reference, on the sampled volumes
    del corrector, generator
    harness.free_device_memory()
    worst, where = 0.0, None
    t_ref = time.perf_counter()
    for index, which, host in kept:
        gap = checks.hu_gap(host, reference(cfg, params, stats, torch.from_numpy(volumes[which]).to(device)).cpu())
        if gap >= worst:
            worst, where = gap, index
    t_ref = time.perf_counter() - t_ref
    limit = cfg["limits"]["correct"]["hu_gap"]
    windows = ref_correct.num_windows(shape, patch, c["overlap"]) if len(patch) == 3 else shape[2]
    measured = Measured("correct", c["dtype"], done, window_s, held, counts.correct_volume(cfg, shape, windows),
                        stretch_units, prof_s, harness.reduce_profile(prof))
    return harness.Outcome(
        end_to_end={"volumes_per_s": done / window_s}, measured=measured,
        checks={"hu_gap": (worst, limit)}, attempted=done, failed=int(not worst <= limit),
        memory_peak_bytes=max(setup_peak, window_peak), window_start=t0,
        notes={"checked": [k[0] for k in kept], "worst_volume": where, "reference_s": t_ref})
