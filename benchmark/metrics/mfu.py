"""``mfu.*``: the model's convolution operations per unit (a training cycle
or a corrected volume, ``benchmark/counts.py``) times the units completed
outside the profiled stretch, over the window's seconds outside it, as a
share of the precision's dense peak (``benchmark/measured.py``), in %."""


def read(m):
    units = m.units - m.stretch_units
    seconds = m.seconds - m.profiler_seconds
    if units <= 0 or seconds <= 0:
        return None
    return 100.0 * units * m.unit_work.flops / seconds / m.peak_flops
