"""``conv_roofline.*``: the least time the chip could take for the model's
convolutions of the units inside the profiled stretch, the sum over each
forward, dgrad and wgrad pass of max(operations / peak, bytes /
bandwidth), over the device time of the convolution kernels in the
stretch (``benchmark/trace.py`` decides which kernels those are), in %."""

from benchmark.measured import PEAK_BYTES


def read(m):
    t = m.trace
    if t is None or t.conv_s <= 0 or m.stretch_units <= 0:
        return None
    return 100.0 * m.stretch_units * m.unit_work.bound_s(m.peak_flops, PEAK_BYTES) / t.conv_s
