"""Reduce a ``torch.profiler`` trace of a measured stretch to what the
per-layer metrics read: the device's busy time, the convolution kernels'
time, the top device operations and the longest idle gaps.

Busy time is the union of the device's kernel intervals (kernels that
overlap count once); host-device copies run on the copy engines and are not
busy time. Which kernels are convolutions is decided in reverse: the
kernels listed by ``NON_CONV`` (ATen's elementwise, reduction, copy, fill,
index and optimizer kernels, memcpy and memset) are not, and every other
kernel is, so an unknown kernel can lower the convolutions' roofline share
but never raise it. Idle gaps are labelled with the benchmark's own span
(a ``bench.*`` host range) in progress where the gap starts, or else where
it ends.
"""

import re
from dataclasses import dataclass, field
from typing import List, Tuple

NON_CONV = re.compile(r"at::native::|at::cuda::|multi_tensor_apply|elementwise_kernel|reduce_kernel|"
                      r"CatArrayBatchedCopy|^Memcpy|^Memset")
COPY_ENGINE = re.compile(r"^Memcpy (HtoD|DtoH|HtoH)")
SPAN_PREFIX = "bench."


def busy_us(intervals) -> float:
    """Microseconds of the union of (start, end) device intervals: kernels
    that overlap (two streams, a graph's parallel branches) count once."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total, end = total + b - a, b
        elif b > end:
            total, end = total + b - end, b
    return total


def is_conv_kernel(name: str) -> bool:
    return NON_CONV.search(name) is None


@dataclass
class Reduced:
    span_s: float = 0.0           # the measured stretch's length
    busy_s: float = 0.0           # union of kernel intervals inside it
    conv_s: float = 0.0           # summed time of convolution kernels
    kernels: int = 0
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def reduce_events(events, stretch: str = "bench.stretch", top: int = 10) -> Reduced:
    """``events``: (name, is_device, start_us, end_us) of one trace, with one
    host range named ``stretch`` around the measured part."""
    spans, device = [], []
    for name, on_device, a, b in events:
        if on_device:
            device.append((name, a, b))
        elif name.startswith(SPAN_PREFIX):
            spans.append((name, a, b))
    window = [s for s in spans if s[0] == stretch]
    if not window:
        raise ValueError(f"the trace has no {stretch!r} range")
    _, w0, w1 = window[0]
    inside = [(n, max(a, w0), min(b, w1)) for n, a, b in device if b > w0 and a < w1]
    busy = [(a, b) for n, a, b in inside if not COPY_ENGINE.match(n)]
    out = Reduced(span_s=(w1 - w0) / 1e6, busy_s=busy_us(busy) / 1e6, kernels=len(busy))
    out.conv_s = sum(b - a for n, a, b in inside if is_conv_kernel(n) and not COPY_ENGINE.match(n)) / 1e6
    by_name = {}
    for n, a, b in inside:
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e6
    out.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    # idle gaps between the busy intervals (and at the stretch's ends)
    merged, end = [], w0
    for a, b in sorted(busy):
        if a > end:
            merged.append((end, a))
        end = max(end, b)
    if w1 > end:
        merged.append((end, w1))
    inner = [s for s in spans if s[0] != stretch]
    gaps = []
    for a, b in merged:
        # the span in progress where the gap starts, else where it ends
        covering = [s for s in inner if s[1] <= a < s[2]] or [s for s in inner if s[1] < b <= s[2]]
        label = min(covering, key=lambda s: s[2] - s[1])[0] if covering else "outside the benchmark's spans"
        gaps.append((label, (b - a) / 1e6))
    out.idle_gaps = sorted(gaps, key=lambda g: -g[1])[:top]
    return out


def profiler_events(prof):
    """(name, is_device, start_us, end_us) of a finished ``torch.profiler``
    run, from its raw events (building the op tree takes seconds). A host
    range also appears on the device's timeline as a user annotation; that
    copy is no device work and is dropped."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == torch.autograd.DeviceType.CUDA
        if on_device and (e.is_user_annotation() or e.name().startswith(SPAN_PREFIX)):
            continue
        a = e.start_ns() / 1e3
        out.append((e.name(), on_device, a, a + e.duration_ns() / 1e3))
    return out
