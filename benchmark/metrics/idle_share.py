"""``idle_share.*``: the share of the profiled stretch in which no kernel
ran on the device, 1 - (union of kernel intervals / the stretch's length),
in %. Nothing without a trace or with no kernel in it."""


def read(m):
    t = m.trace
    if t is None or t.kernels == 0 or t.span_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.span_s)
