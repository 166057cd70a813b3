"""The program's own spans in a profiled stretch: what each held of the
host's time, the device's time and the device's idle time.

The port marks its layers with named host ranges (``utils/spans.py`` of
the port: ``train.*``, ``correct.*``, ``gen.<stage>``), which a running
``torch.profiler`` records on the device's clock. A program span here is
any host range not prefixed ``bench.`` (torch's own, such as
``Optimizer.step#Adam.step``, count too). For each name, over the
``bench.stretch`` range:

- ``count`` and ``host_s``: the spans and their seconds inside the stretch;
- ``device_s``: the device work (``benchmark/trace.py``'s busy operations:
  kernels, memsets and device-to-device copies, not the copy engines'
  host-device copies) whose launch call lies innermost in the span. A
  kernel is matched to its launch call (the CUDA API call on the host:
  ``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaGraphLaunch``, ...) by
  correlation id; a replayed graph's kernels carry its
  ``cudaGraphLaunch``'s id, so they go to the span around the replay;
- ``idle_s``: the stretch's idle gaps, found as ``trace.reduce_events``
  finds them, each divided over the innermost program spans in progress
  along it (a part in no program span goes to none). ``trace.py`` gives a
  whole gap one label, the span where it starts, else where it ends; for
  a span's seconds that misleads: the gap of a volume's copy in starts
  before the volume's first span and ends in ``correct.prepare``, which
  would take all of it from ``correct.h2d``.

The functions below read per-layer figures from that reduction and the
corrector's ``counts``; each gives None where the trace has none of what
it reads (a program without spans). Run one cell with the reduction beside
its own result::

    python3 benchmark/program_spans.py --workload <cell> --seed <n> --seconds <s>

which prints the run's result line with a ``program`` entry added: the
figures, the corrector's counts over the run, and every span by device
seconds as ``[name, host_s, device_s, idle_s]``.
"""

import bisect
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

if __name__ == "__main__" and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from benchmark.trace import COPY_ENGINE, SPAN_PREFIX  # noqa: E402

STRETCH = "bench.stretch"


@dataclass
class SpanTotals:
    count: int = 0
    host_s: float = 0.0
    device_s: float = 0.0
    idle_s: float = 0.0


def program_events(prof) -> list:
    """(kind, name, start_us, end_us, correlation, thread) of a finished
    ``torch.profiler`` run, from its raw events. ``kind``: "range" (a host
    range: the program's spans and the benchmark's), "launch" (a CUDA API
    call on the host, ``cu*``) or "device" (work on the device; a
    host range's copy on the device's timeline, which bears its name, is
    dropped)."""
    import torch

    out, device = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a = e.start_ns() / 1e3
        b = a + e.duration_ns() / 1e3
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append(("device", name, a, b, e.correlation_id(), None))
        elif e.is_user_annotation():
            out.append(("range", name, a, b, None, e.start_thread_id()))
        elif name.startswith("cu"):
            out.append(("launch", name, a, b, e.correlation_id(), e.start_thread_id()))
    ranges = {ev[1] for ev in out if ev[0] == "range"}
    return out + [ev for ev in device if ev[1] not in ranges]


def _timeline(spans, thread=None) -> tuple:
    """The innermost span in progress (``start <= t < end``; across threads
    the shortest such) over all of time, as (segment starts, segments
    ``(start, end, index into spans or None)``) in order. ``spans``:
    (name, start, end, thread); ``thread``: only that thread's spans."""
    points = []
    for i, (_, a, b, tid) in enumerate(spans):
        if b > a and (thread is None or tid == thread):
            # a parent opens before and closes after a child on the same tick
            points += [(a, 1, -(b - a), i, tid), (b, 0, b - a, i, tid)]
    open_by_thread: Dict[object, list] = {}
    out, t0, current = [], float("-inf"), None
    for t, starts, _, i, tid in sorted(points, key=lambda q: q[:4]):
        if t > t0:
            out.append((t0, t, current))
            t0 = t
        if starts:
            open_by_thread.setdefault(tid, []).append(i)
        else:
            open_by_thread[tid].remove(i)
        tops = [s[-1] for s in open_by_thread.values() if s]
        current = min(tops, key=lambda k: spans[k][2] - spans[k][1]) if tops else None
    out.append((t0, float("inf"), current))
    return [seg[0] for seg in out], out


def _at(timeline, t):
    """The innermost span of a :func:`_timeline` at time ``t``."""
    starts, segments = timeline
    return segments[bisect.bisect_right(starts, t) - 1][2]


def reduce_program(events, stretch: str = STRETCH) -> Dict[str, SpanTotals]:
    """``{span name: SpanTotals}`` over the stretch (see the module's
    docstring); empty where the trace holds no program span."""
    window = [(a, b) for kind, name, a, b, _, _ in events if kind == "range" and name == stretch]
    if not window:
        raise ValueError(f"the trace has no {stretch!r} range")
    w0, w1 = window[0]
    spans = [(name, a, b, tid) for kind, name, a, b, _, tid in events
             if kind == "range" and not name.startswith(SPAN_PREFIX) and b > w0 and a < w1]
    out: Dict[str, SpanTotals] = {}
    for name, a, b, _ in spans:
        t = out.setdefault(name, SpanTotals())
        t.count += 1
        t.host_s += (min(b, w1) - max(a, w0)) / 1e6
    if not spans:
        return out
    # device time: the innermost span on the launching thread at the launch
    timelines = {tid: _timeline(spans, tid) for tid in {s[3] for s in spans}}
    launches = {corr: (a, tid) for kind, _, a, _, corr, tid in events if kind == "launch"}
    busy = [(max(a, w0), min(b, w1), corr) for kind, name, a, b, corr, _ in events
            if kind == "device" and b > w0 and a < w1 and not COPY_ENGINE.match(name)]
    for a, b, corr in busy:
        t, tid = launches.get(corr, (None, None))
        i = _at(timelines[tid], t) if tid in timelines else None
        if i is not None:
            out[spans[i][0]].device_s += (b - a) / 1e6
    # the idle gaps between the busy intervals, as trace.reduce_events finds
    # them, each divided over the innermost spans in progress along it
    gaps, end = [], w0
    for a, b, _ in sorted(busy):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if w1 > end:
        gaps.append((end, w1))
    _, timeline = _timeline(spans)
    k = 0
    for a, b in gaps:
        while timeline[k][1] <= a:
            k += 1
        j = k
        while j < len(timeline) and timeline[j][0] < b:
            t0, t1, i = timeline[j]
            if i is not None:
                out[spans[i][0]].idle_s += (min(t1, b) - max(t0, a)) / 1e6
            j += 1
    return out


def _of_layer(program: Dict[str, SpanTotals], *layers: str) -> List[SpanTotals]:
    return [t for name, t in program.items() if name.split(".")[0] in layers]


def entry_idle_share(program: Optional[Dict[str, SpanTotals]], span_s: float, layer: str) -> Optional[float]:
    """The idle seconds given to ``<layer>.*`` spans and the ``gen.*``
    spans inside them, over the stretch's seconds, in %. A stretch runs
    one entry (a cell trains or corrects), so its ``gen.*`` spans are that
    entry's."""
    if not program or span_s <= 0 or not _of_layer(program, layer):
        return None
    return 100.0 * sum(t.idle_s for t in _of_layer(program, layer, "gen")) / span_s


def dispatch_ms(program: Optional[Dict[str, SpanTotals]], name: str = "train.cycle") -> Optional[float]:
    """The mean host milliseconds of a ``name`` span in the stretch (the
    profiler's own cost included)."""
    t = (program or {}).get(name)
    return None if t is None or t.count == 0 else 1e3 * t.host_s / t.count


def window_ms(program: Optional[Dict[str, SpanTotals]], units: int, layer: str = "correct") -> Optional[float]:
    """Device milliseconds per unit (a stretch volume) of the work launched
    inside ``<layer>.*`` spans and outside every ``gen.*`` span: the
    sliding window's or the slice loop's own device time."""
    spans = _of_layer(program or {}, layer)
    if not spans or units <= 0:
        return None
    return 1e3 * sum(t.device_s for t in spans) / units


def useful_share(counts: Optional[dict]) -> Optional[float]:
    """100 x ``useful`` / ``samples`` of a corrector's ``counts``."""
    if not counts or not counts.get("samples"):
        return None
    return 100.0 * counts["useful"] / counts["samples"]


def span_rows(program: Dict[str, SpanTotals]) -> list:
    """``[name, host_s, device_s, idle_s]`` of every span, by device
    seconds."""
    rows = sorted(program.items(), key=lambda kv: -kv[1].device_s)
    return [[name, t.host_s, t.device_s, t.idle_s] for name, t in rows]


def traced_cell(workload: str, seed: int, seconds: float, device: str = "cuda", **cell):
    """Run one cell with ``--trace 1`` and reduce its profiled stretch to
    program spans too. Returns the run's result dict with ``program``
    added. The run is the benchmark's own (``run.run_cell``, which takes
    ``cell``'s ``config`` and ``mix``): its reduction of the profile is
    wrapped to keep the events, and each corrector it builds hands over
    its ``counts`` (None where the program has none)."""
    from unittest import mock

    from benchmark import harness, run
    from contrast_gan_3d_tpu_torch.eval.corrector import CCTAContrastCorrector

    kept, counts = {}, []
    reduce_profile, init = harness.reduce_profile, CCTAContrastCorrector.__init__

    def reduce_and_keep(prof):
        if prof is not None:
            kept["events"] = program_events(prof)
        return reduce_profile(prof)

    def init_and_keep(self, *args, **kwargs):
        init(self, *args, **kwargs)
        counts.append(getattr(self, "counts", None))

    with mock.patch.object(harness, "reduce_profile", reduce_and_keep), \
            mock.patch.object(CCTAContrastCorrector, "__init__", init_and_keep):
        result, outcome = run.run_cell(workload, seed, seconds, True, device, **cell)
    program = reduce_program(kept["events"]) if "events" in kept else {}
    t = outcome.measured.trace
    span_s = t.span_s if t is not None else 0.0
    layer = outcome.measured.kind
    total = None
    if counts and all(c is not None for c in counts):
        total = {k: sum(c[k] for c in counts) for k in counts[0]}
    figures = {f"entry_idle_share.{layer}": entry_idle_share(program, span_s, layer)}
    if layer == "train":
        figures["dispatch_ms.train"] = dispatch_ms(program)
    else:
        figures["useful_share.correct"] = useful_share(total)
        figures["window_ms.correct"] = window_ms(program, outcome.measured.stretch_units)
    result["program"] = {"figures": figures, "counts": total, "program_spans": span_rows(program)}
    return result


def main(argv=None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(description="Run one cell traced and reduce its stretch to program spans.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)
    from benchmark import run

    run.cache_dirs(run.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("program_spans: this run needs a CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(traced_cell(args.workload, args.seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
