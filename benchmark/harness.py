"""Pieces every loop shares: handing the benchmark's weights to the
program, the profiled stretch, the reference's precision, and a loop's
outcome."""

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import torch

from benchmark import trace
from benchmark.measured import Measured


@dataclass
class Outcome:
    """What a loop hands back to ``run.py``."""

    end_to_end: Dict[str, float]          # by metric name, without setup_s
    measured: Measured
    checks: Dict[str, Tuple[float, float]]  # name -> (value, limit)
    attempted: int
    failed: int
    memory_peak_bytes: int
    window_start: float                   # time.perf_counter() of the first timed unit
    notes: Dict[str, object] = field(default_factory=dict)


@torch.no_grad()
def load_into(module: torch.nn.Module, params: Dict[str, torch.Tensor],
              buffers: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """Copy the benchmark's weights (and running statistics) into a module
    of the program; the names and shapes must match the reference's
    exactly."""
    own = dict(module.named_parameters())
    if set(own) != set(params):
        raise ValueError(f"the program's parameters differ from the reference's: only the program has "
                         f"{sorted(set(own) - set(params))}, only the reference {sorted(set(params) - set(own))}")
    for name, p in own.items():
        if tuple(p.shape) != tuple(params[name].shape):
            raise ValueError(f"{name}: the program's shape {tuple(p.shape)}, the reference's "
                             f"{tuple(params[name].shape)}")
        p.copy_(params[name])
    bufs = dict(module.named_buffers())
    for name, b in (buffers or {}).items():
        bufs[name].copy_(b)


@contextlib.contextmanager
def full_f32():
    """The reference's float32: TF32 off in cuDNN and cuBLAS."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_stretch(run_units: Callable[[], int], device: torch.device):
    """Run ``run_units()`` (which returns how many whole units it ran)
    under ``torch.profiler`` inside a ``bench.stretch`` range that ends
    with the device idle. Returns the profiler (reduce it with
    :func:`reduce_profile` once the window has closed), the units, and the
    seconds of the whole profiled block, the profiler's start and stop
    included."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("bench.stretch"):
            units = run_units()
            sync(device)
    return prof, units, time.perf_counter() - t0


def reduce_profile(prof) -> Optional[trace.Reduced]:
    return None if prof is None else trace.reduce_events(trace.profiler_events(prof))


def free_device_memory() -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
