"""Run one cell of the port's benchmark on one card and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell, its configuration and its traffic
mix are found by name (``benchmark/spec.py``). ``--trace 0`` prints the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` trace of a stretch in the middle of the window, and a
breakdown of that stretch. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each compared
number beside its limit); the compared numbers are also the last lines of
standard error.

Exit codes: 0 with a result; 2 without a card (or with fewer than the cell
asks for), printing nothing; 3 if JAX, flax or the JAX package was loaded
into this process, printing nothing.
"""

import os
import sys
import time
from pathlib import Path

_T_IMPORT = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
# the checkout's root, not this folder, on the path: the benchmark's modules
# are ``benchmark.*`` and must not shadow top-level ones
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path[0] = str(ROOT)

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "optax", "contrast_gan_3d_tpu")


def process_age_s() -> float:
    """Seconds since this process started (``/proc``), or since this module
    was imported where ``/proc`` cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    cache = root / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda", root: Path = ROOT,
             config: dict = None, mix: dict = None):
    """Run one cell; returns the result dict and the outcome. ``config`` and
    ``mix`` replace the cell's files (the tests' small sizes)."""
    import torch

    from benchmark import spec as specs

    spec = specs.load_spec(root)
    cell = specs.workload(spec, workload)
    config = config or specs.config(spec, cell["config"], root)
    mix = mix or specs.traffic(cell["traffic"], root / "benchmark")
    loop = specs.loop(mix, root / "benchmark")
    dev = torch.device(device)
    outcome = loop.run(config, mix, seed, seconds, trace, dev)
    setup_s = process_age_s() - (time.perf_counter() - outcome.window_start)

    correct = all(v <= limit for v, limit in outcome.checks.values())
    metrics = {}
    if trace:
        for m in specs.per_layer(spec, workload):
            value = specs.reader(m["name"], root / "benchmark")(outcome.measured)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in specs.end_to_end(spec, workload):
            value = setup_s if m["name"] == "setup_s" else outcome.end_to_end[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": outcome.memory_peak_bytes,
                   "power_limit_w": power_limit_w() if dev.type == "cuda" else None}
    result = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed, "metrics": metrics,
              "device": device_info}
    t = outcome.measured.trace
    if trace and t is not None:
        device_info["busy_s"], device_info["window_s"] = t.busy_s, t.span_s
        result["breakdown"] = {"device_ops": [list(x) for x in t.device_ops],
                               "idle_gaps": [list(x) for x in t.idle_gaps]}
    result["checks"] = {k: {"value": v, "limit": limit} for k, (v, limit) in outcome.checks.items()}
    return result, outcome


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cache_dirs(ROOT)

    import torch

    from benchmark import spec as specs

    chips = specs.workload(specs.load_spec(ROOT), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell {args.workload} needs {chips} CUDA device(s), this machine has {n}",
              file=sys.stderr)
        return 2
    result, outcome = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = banned_modules()
    if found:
        print(f"benchmark: the process loaded {', '.join(found)}; the port's benchmark may load none of "
              f"{', '.join(BANNED)}", file=sys.stderr)
        return 3
    print(f"notes {json.dumps(outcome.notes)}", file=sys.stderr)
    for name, (value, limit) in outcome.checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
