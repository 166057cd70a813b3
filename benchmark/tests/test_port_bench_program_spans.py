"""The reduction of a stretch to the program's spans, on synthetic events
and in one small traced run on the CPU: kernels go to the span of their
launch call by correlation id (a graph's to the span around its replay),
idle gaps are divided over the innermost program spans along them, the
trace's own reduction is the same with program spans in the trace, and
every figure is None where the program has no spans or counts."""

import pytest

from benchmark import program_spans as ps
from benchmark import trace
from benchmark.tests import small

# a stretch of 100 us: a correction's batch with one generator stage, a
# replay, and a copy in
EVENTS = [
    ("range", "bench.stretch", 0.0, 100.0, None, 1),
    ("range", "bench.correct", 1.0, 60.0, None, 1),
    ("range", "correct.volume", 2.0, 60.0, None, 1),
    ("range", "correct.h2d", 2.0, 10.0, None, 1),
    ("range", "correct.batch", 12.0, 40.0, None, 1),
    ("range", "gen.first", 14.0, 30.0, None, 1),
    ("range", "correct.blend", 42.0, 58.0, None, 1),
    ("range", "train.replay", 70.0, 72.0, None, 1),
    ("launch", "cudaMemcpyAsync", 3.0, 9.0, 7, 1),
    ("launch", "cudaLaunchKernel", 15.0, 16.0, 8, 1),      # inside gen.first
    ("launch", "cudaLaunchKernel", 32.0, 33.0, 9, 1),      # in the batch, after the stage
    ("launch", "cudaGraphLaunch", 70.5, 71.5, 10, 1),
    ("launch", "cudaLaunchKernel", 45.0, 46.0, 11, 1),     # inside correct.blend
    ("device", "Memcpy HtoD (Pageable -> Device)", 4.0, 9.0, 7, None),
    ("device", "conv_kernel", 16.0, 30.0, 8, None),
    ("device", "void at::native::elementwise_kernel<>", 33.0, 36.0, 9, None),
    ("device", "graph_kernel_a", 71.0, 80.0, 10, None),
    ("device", "graph_kernel_b", 80.0, 90.0, 10, None),
    ("device", "blend_kernel", 48.0, 50.0, 11, None),
    ("device", "unlaunched_kernel", 95.0, 105.0, 99, None),  # no launch seen; runs past the stretch
]


def test_kernels_go_to_the_span_of_their_launch():
    p = ps.reduce_program(EVENTS)
    assert p["gen.first"].device_s == pytest.approx(14e-6)
    assert p["correct.batch"].device_s == pytest.approx(3e-6)
    assert p["correct.blend"].device_s == pytest.approx(2e-6)
    # a replay's kernels run after its span has closed: still the replay's
    assert p["train.replay"].device_s == pytest.approx(19e-6)
    # the copy engines' copies are no busy time; the bench spans are not the program's
    assert p["correct.h2d"].device_s == 0.0 and "bench.correct" not in p
    assert sum(t.device_s for t in p.values()) == pytest.approx(38e-6)
    assert p["correct.volume"].count == 1 and p["correct.volume"].host_s == pytest.approx(58e-6)


def test_idle_gaps_are_divided_over_the_innermost_program_spans():
    p = ps.reduce_program(EVENTS)
    # busy 16-30, 33-36, 48-50, 71-90, 95-100, so the gaps 0-16, 30-33,
    # 36-48, 50-71 and 90-95, each divided along the innermost span: the
    # copy in's gap goes to correct.h2d, though it starts before any span
    # and ends in gen.first
    want = {"correct.h2d": 8, "correct.volume": 2 + 2 + 2, "correct.batch": 2 + 3 + 4, "gen.first": 2,
            "correct.blend": 6 + 8, "train.replay": 1}
    assert {k: t.idle_s for k, t in p.items() if t.idle_s} == pytest.approx({k: v * 1e-6 for k, v in want.items()})
    # 0-2, 60-70 and 90-95 lie in no program span
    assert ps.entry_idle_share(p, 100e-6, "correct") == pytest.approx(39.0)


def test_the_trace_reduction_is_unchanged_by_program_spans():
    as_trace = lambda evs: [(name, kind == "device", a, b) for kind, name, a, b, _, _ in evs if kind != "launch"]
    bench_only = [e for e in EVENTS if e[0] != "range" or e[1].startswith("bench.")]
    assert trace.reduce_events(as_trace(EVENTS)) == trace.reduce_events(as_trace(bench_only))


def test_figures_say_nothing_without_spans_or_counts():
    bare = ps.reduce_program([e for e in EVENTS if e[0] != "range" or e[1].startswith("bench.")])
    assert bare == {}
    assert ps.entry_idle_share(bare, 1e-4, "correct") is None and ps.entry_idle_share(None, 1e-4, "train") is None
    assert ps.dispatch_ms(bare) is None and ps.window_ms(bare, 1) is None
    assert ps.useful_share(None) is None and ps.useful_share({"samples": 0, "useful": 0}) is None
    assert ps.useful_share({"samples": 512, "useful": 400}) == 78.125


def test_a_small_traced_correction_reads_its_spans_and_counts():
    cfg_name, mix_name = small.CELLS["correct.conf_2d.z400"]
    result = ps.traced_cell("correct.conf_2d.z400", 2**31 + 5, 0.5, "cpu", config=small.config(cfg_name),
                            mix=small.mix(mix_name))
    assert result["correct"] is True
    program = result["program"]
    names = [row[0] for row in program["program_spans"]]
    assert {"correct.volume", "correct.batch", "gen.first"} <= set(names)
    # 24 slices at batch 8: no padding
    counts = program["counts"]
    assert counts["samples"] == counts["useful"] == 24 * counts["volumes"]
    assert program["figures"]["useful_share.correct"] == 100.0
