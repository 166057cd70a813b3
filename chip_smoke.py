"""Drive the PyTorch/CUDA port on one NVIDIA card and hold every ported
kernel against its plain PyTorch version.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases (any failure raises and exits non-zero):
1. build the CUDA kernels from ``contrast_gan_3d_tpu_torch/ops/csrc`` into
   ``build/torch_kernels/`` and print the card's name and power limit;
2. kernels: B1 (``block_conv3x3x3``) and B3 (``s2d_conv3d_block``) at the
   generator's batch-8 stem and projection shapes, f32 and bf16, against
   their plain versions, with CUDA-event medians of the kernel, the plain
   version and one PyTorch library call (a yardstick the port never calls)
   beside the least time the card could take (the bound);
3. main path: the default 1,035,297-parameter ``ResnetGenerator`` with
   seeded random weights corrects three int16 512x512x128 volumes through
   ``CCTAContrastCorrector`` (128^3 patches, 25% overlap, batch 8: 25
   patches, 4 generator forwards, 8 B1 launches per volume);
   then one 512x512x400 volume at 25% and one at 50% overlap (74 B1
   launches);
4. path parity: one 96x96x64 volume corrected on the card and on the CPU
   with the same weights must agree to 0.5 HU;
5. where the time goes: device time by kernel over one 512x512x128
   correction under ``torch.profiler``.

The last two lines are a ``{"kernels": [...]}`` JSON object and
``{"ok": true, "device": {...}}``.
"""

import collections
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from contrast_gan_3d_tpu_torch.eval.corrector import CCTAContrastCorrector
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.models.utils import count_parameters
from contrast_gan_3d_tpu_torch.ops import _build
from contrast_gan_3d_tpu_torch.ops.block_conv import (
    block_conv3x3x3,
    block_conv3x3x3_reference,
    s2d_conv3d_block,
)
from contrast_gan_3d_tpu_torch.ops.s2d_conv import s2d_conv3d
from contrast_gan_3d_tpu_torch.ops.sliding_window import num_patches

# H100 SXM dense peaks (NVIDIA data sheet): f32 outside the tensor cores,
# bf16 on them, and HBM3 bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES_PER_S = 3.35e12
# max |kernel - plain| / max |plain|
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-3}
# B3 returns x's dtype: a bf16 output is rounded to bf16 (half an ulp is up
# to 2^-8 of the value), so no bf16 B3 can sit closer than that to the f32
# truth; its bf16 check uses that bound
B3_BF16_REL_TOL = 2.0**-8
PATH_TOL_HU = 0.5
BATCH = 8
B1_SHAPES = {"stem": (64, 1024), "projection": (1024, 64)}  # (Ci, Co) over 34^3 blocks
B3_SHAPES = {"stem": (1, 16, False), "projection": (16, 1, True)}  # (Ci, Co, bias) at 128^3


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, nbytes: float, dtype) -> tuple:
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def compare(got, ref, tol, what):
    err = (got.float() - ref.float()).abs().max().item()
    rel = err / ref.float().abs().max().item()
    print(f"  {what}: max_abs_err={err:.3e} max_rel_err={rel:.3e} (tol {tol:.1e})", flush=True)
    if not rel <= tol:
        raise AssertionError(f"{what}: relative error {rel:.3e} > {tol:.1e}")
    return err, rel


def kernel_phase(dev, g):
    """Per (kernel, stage, dtype): errors and times at the main path's shapes."""
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for stage, (ci, co) in B1_SHAPES.items():
            x = torch.randn((BATCH, 34, 34, 34, ci), generator=g).to(dev, dtype)
            w = (torch.randn((3, 3, 3, ci, co), generator=g) / (27 * ci) ** 0.5).to(dev, dtype)
            got = block_conv3x3x3(x, w)
            ref = block_conv3x3x3_reference(x, w)
            torch.cuda.synchronize()
            what = f"B1 block_conv3x3x3 {stage} {dtype}"
            err, rel = compare(got, ref, REL_TOL[dtype], what)
            # the library yardstick reads the same memory as NCDHW
            # (channels-last strides): conv over (Z, X, Y) with w[qx,qy,qz]
            xc, wc = x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 2, 0, 1)
            if dtype == torch.float32:
                compare(F.conv3d(xc, wc).permute(0, 2, 3, 4, 1), ref, REL_TOL[dtype],
                        f"{what} (library conv vs plain)")
            zo = 32
            flops = 2 * BATCH * zo**3 * 27 * ci * co
            b_ms, b_by = bound(flops, nbytes(x, w, got), dtype)
            ms = median_ms(lambda: block_conv3x3x3(x, w))
            rows.append(dict(
                name="block_conv3x3x3", stage=stage, dtype=str(dtype).split(".")[-1],
                route="cuda", source="contrast_gan_3d_tpu_torch/ops/csrc/block_conv.cu",
                replaces="contrast_gan_3d_tpu/ops/pallas_conv.py:96",
                max_abs_err=err, max_rel_err=rel, ms=ms,
                plain_ms=median_ms(lambda: block_conv3x3x3_reference(x, w)),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=median_ms(lambda: F.conv3d(xc, wc)),
                tflops=flops / ms / 1e9,
            ))
            del x, w, got, ref, xc, wc
            torch.cuda.empty_cache()
        for stage, (ci, co, has_bias) in B3_SHAPES.items():
            x = torch.randn((BATCH, 128, 128, 128, ci), generator=g).to(dev, dtype)
            w = (torch.randn((7, 7, 7, ci, co), generator=g) / (343 * ci) ** 0.5).to(dev, dtype)
            b = torch.randn((co,), generator=g).to(dev, dtype) if has_bias else None
            got = s2d_conv3d_block(x, w, b, f=4, padding_mode="reflect")
            # the plain version in f32 on the same (possibly bf16) values
            ref = s2d_conv3d(x.float(), w.float(), None if b is None else b.float(),
                             f=4, padding_mode="reflect")
            torch.cuda.synchronize()
            tol = REL_TOL[dtype] if dtype == torch.float32 else B3_BF16_REL_TOL
            err, rel = compare(got, ref, tol, f"B3 s2d_conv3d_block {stage} {dtype}")
            xc, wc = x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2)

            def library():
                return F.conv3d(F.pad(xc, (3,) * 6, mode="reflect"), wc, b)

            flops = 2 * BATCH * 128**3 * 343 * ci * co
            b_ms, b_by = bound(flops, nbytes(x, w, b, got), dtype)
            rows.append(dict(
                name="s2d_conv3d_block", stage=stage, dtype=str(dtype).split(".")[-1],
                route="cuda", source="contrast_gan_3d_tpu_torch/ops/block_conv.py",
                replaces="contrast_gan_3d_tpu/ops/pallas_conv.py:220",
                max_abs_err=err, max_rel_err=rel,
                ms=median_ms(lambda: s2d_conv3d_block(x, w, b, f=4, padding_mode="reflect")),
                plain_ms=median_ms(lambda: s2d_conv3d(x, w, b, f=4, padding_mode="reflect")),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=median_ms(library),
            ))
            del x, w, b, got, ref, xc, wc
            torch.cuda.empty_cache()
    for r in rows:
        print("  " + json.dumps(r), flush=True)
    return rows


def seeded_generator(seed: int) -> ResnetGenerator:
    """The default generator with lecun-normal conv weights and non-trivial
    BatchNorm parameters and running statistics, all from one seed."""
    gen = ResnetGenerator()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if p.dim() > 1:
                p.copy_(torch.randn(p.shape, generator=g) / p[0].numel() ** 0.5)
            elif name.endswith("norm.weight"):
                p.copy_(1 + 0.1 * torch.randn(p.shape, generator=g))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
        for name, buf in gen.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=g))
    return gen


def path_phase(gen, rng):
    """The requests of the main path through the CUDA corrector: three
    512x512x128 volumes at 25% overlap, then one 512x512x400 volume at 25%
    and one at 50% (the JAX package's headline volume). The B1/B3 counts
    are zeroed just before and read just after."""
    correctors = {
        overlap: CCTAContrastCorrector(
            gen, inference_patch_size=(128, 128, 128), overlap=overlap, batch_size=BATCH
        )
        for overlap in (0.25, 0.5)
    }
    requests = [((512, 512, 128), 0.25)] * 3 + [((512, 512, 400), 0.25), ((512, 512, 400), 0.5)]
    vols = [rng.integers(-1024, 1500, shape).astype(np.int16) for shape, _ in requests]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    block_conv3x3x3.launches = 0
    s2d_conv3d_block.launches = 0
    results = []
    for vol, (shape, overlap) in zip(vols, requests):
        before = block_conv3x3x3.launches
        t0 = time.perf_counter()
        out = correctors[overlap](vol)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        forwards = -(-num_patches(shape, (128, 128, 128), overlap) // BATCH)
        results.append(dict(shape=shape, overlap=overlap, seconds=seconds, forwards=forwards,
                            b1_launches=block_conv3x3x3.launches - before))
        if tuple(out.shape) != vol.shape or not torch.isfinite(out).all():
            raise AssertionError("corrected volume has the wrong shape or non-finite values")
        # the attenuation is a blend of tanh outputs: |correction| < 600 HU
        delta = (out.cpu() - torch.from_numpy(vol).float()).abs().max().item()
        if not delta < 600.0 + 1e-2:
            raise AssertionError(f"correction of {delta} HU exceeds the 600 HU bound")
    launches = {"block_conv3x3x3": block_conv3x3x3.launches,
                "s2d_conv3d_block": s2d_conv3d_block.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for r in results:
        print(f"path: {r}", flush=True)
    print(f"path: launches {launches}; peak memory {peak_gib:.2f} GiB", flush=True)
    # two B1 launches (stem + projection) per generator forward: 8 per
    # 512x512x128 volume at 25% overlap, 74 per 512x512x400 at 50%
    expected = [2 * r["forwards"] for r in results]
    if [r["b1_launches"] for r in results] != expected or launches["s2d_conv3d_block"] != sum(expected):
        raise AssertionError(f"expected B1/B3 launches {expected}, got {results}, {launches}")
    if expected[:3] != [8, 8, 8] or expected[-1] != 74:
        raise AssertionError(f"unexpected patch grid: {expected}")
    return launches, results


def parity_phase(gen, state, rng):
    vol = rng.integers(-1024, 1500, (96, 96, 64)).astype(np.int16)
    kw = dict(inference_patch_size=(64, 64, 64), overlap=0.25, batch_size=BATCH)
    on_card = CCTAContrastCorrector(gen, **kw)(vol).cpu()
    gen_cpu = ResnetGenerator()
    gen_cpu.load_state_dict(state, strict=True)
    on_cpu = CCTAContrastCorrector(gen_cpu, device="cpu", **kw)(vol)
    diff = (on_card - on_cpu).abs().max().item()
    print(f"path parity (96x96x64, 64^3 patches): max |cuda - cpu| = {diff:.4f} HU "
          f"(tol {PATH_TOL_HU})", flush=True)
    if not diff <= PATH_TOL_HU:
        raise AssertionError(f"CUDA and CPU corrections differ by {diff} HU")


def profile_phase(gen, rng):
    """Where the time goes: device time by kernel over one 512x512x128
    correction under torch.profiler, and the device's busy share of the
    wall time (the profiler's own cost is inside that wall time)."""
    corrector = CCTAContrastCorrector(
        gen, inference_patch_size=(128, 128, 128), overlap=0.25, batch_size=BATCH
    )
    vol = rng.integers(-1024, 1500, (512, 512, 128)).astype(np.int16)
    corrector(vol)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        corrector(vol)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    if not busy_us:
        print("profile: the profiler recorded no device time (not measured)", flush=True)
        return
    print(f"profile: wall {wall_us / 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
          f"({100 * busy_us / wall_us:.1f}%), {sum(1 for _ in by_name)} kernel names", flush=True)
    for name, us in by_name.most_common(15):
        print(f"  {us / 1e3:9.2f} ms {100 * us / busy_us:5.1f}%  {name[:110]}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = nvidia_smi()
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    rebuilt = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s, rebuilt {rebuilt}", flush=True)
    for name in rebuilt:
        log = _build.build_log_path(name)
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}", flush=True)

    g = torch.Generator().manual_seed(0)
    rows = kernel_phase(dev, g)

    gen = seeded_generator(0)
    state = {k: v.clone() for k, v in gen.state_dict().items()}
    if count_parameters(gen) != 1_035_297:
        raise AssertionError(f"default generator has {count_parameters(gen)} parameters")
    rng = np.random.default_rng(0)
    launches, results = path_phase(gen, rng)
    parity_phase(gen, state, rng)
    profile_phase(gen, rng)

    kernels = []
    for r in rows:
        if r["dtype"] == "float32":  # the main path's dtype
            kernels.append(dict(r, launches=launches[r["name"]]))
    print(json.dumps({"requests": results, "card": smi}))
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
