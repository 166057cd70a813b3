"""The benchmark's own arithmetic and bookkeeping, on the CPU: the model
counts, the kernel rule, the union of intervals and the trace reduction,
how files are found by name, the contract ``BENCHMARK.json`` keeps, and
the run's refusal without a card."""

import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import counts, trace
from benchmark import spec as specs
from benchmark.measured import PEAK_BYTES, Measured

ROOT = Path(__file__).resolve().parents[2]


def test_two_conv_model_counted_by_hand():
    a = counts.Conv("a", 2, 4, 3, (8, 8, 8), (8, 8, 8))
    b = counts.Conv("b", 4, 1, 3, (8, 8, 8), (4, 4, 4))
    t = counts.Tally(2).add([a, b], 5, "fwd")
    assert t.flops == 2 * 5 * 2 * 4 * 27 * 512 + 2 * 5 * 4 * 1 * 27 * 64
    assert t.bytes == 2 * ((5 * 2 * 512 + 2 * 4 * 27 + 5 * 4 * 512) + (5 * 4 * 512 + 4 * 27 + 5 * 64))
    peak = 1e12
    assert t.bound_s(peak, PEAK_BYTES) == pytest.approx(
        max(2 * 5 * 2 * 4 * 27 * 512 / peak, 2 * (5120 + 216 + 10240) / PEAK_BYTES)
        + max(2 * 5 * 4 * 27 * 64 / peak, 2 * (10240 + 108 + 320) / PEAK_BYTES))
    # a gradient pass leaves out the first conv's input gradient
    assert counts.Tally(2).add([a, b], 5, "dgrad", skip_first=True).flops == b.flops(5)
    # a stride-2 transpose conv counts its input points
    up = counts.Conv("up", 4, 2, 3, (4, 4, 4), (8, 8, 8), transpose=True)
    assert up.flops(1) == 2 * 4 * 2 * 27 * 64


def test_train_cycle_counts_each_branch():
    cfg = specs.config(specs.load_spec(), "basic_3d")
    g = counts.generator_convs(cfg["generator"], cfg["train"]["patch"])
    d = counts.critic_convs(cfg["critic"], cfg["train"]["patch"])
    gf, df = (sum(c.flops(1) for c in x) for x in (g, d))
    critic_update = 12 * df * 2 + (12 * df - 12 * d[0].flops(1))
    generator_update = 6 * df * 2 + 6 * gf * 2 - 6 * g[0].flops(1)
    expected = 5 * (6 * gf + critic_update) + generator_update
    got = counts.train_cycle(cfg, ["combined", "critic", "critic", "critic", "critic"]).flops
    assert got == pytest.approx(expected)


@pytest.mark.parametrize("name,conv", [
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64", True),
    ("some_kernel_no_rule_has_heard_of", True),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>(int)", False),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>(...)", False),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<...>(...)", False),
    ("Memcpy DtoD (Device -> Device)", False),
    ("Memset (Device)", False),
])
def test_kernel_rule_counts_unknown_kernels_as_convolutions(name, conv):
    assert trace.is_conv_kernel(name) is conv


def test_busy_us_counts_overlaps_once():
    assert trace.busy_us([(0, 10), (5, 15), (20, 30), (22, 25)]) == 25
    assert trace.busy_us([(3, 4), (0, 1)]) == 2
    assert trace.busy_us([]) == 0


def test_reduce_events_busy_gaps_and_labels():
    events = [
        ("bench.stretch", False, 0.0, 100.0),
        ("bench.cycle", False, 2.0, 30.0),
        ("bench.d2h", False, 60.0, 90.0),
        ("conv_kernel", True, 10.0, 40.0),
        ("void at::native::elementwise_kernel<>", True, 35.0, 50.0),
        ("Memcpy DtoH (Device -> Pageable)", True, 60.0, 80.0),
        ("conv_kernel", True, 95.0, 110.0),  # runs past the stretch: clipped
    ]
    r = trace.reduce_events(events)
    assert r.span_s == pytest.approx(100e-6)
    assert r.busy_s == pytest.approx(45e-6)  # 10-50 and 95-100; the copy is not busy
    assert r.conv_s == pytest.approx(35e-6)
    assert r.device_ops[0] == ("conv_kernel", pytest.approx(35e-6))
    # the gaps 0-10 and 50-95, labelled by the span in progress where each
    # starts, or else where it ends
    assert r.idle_gaps == [("outside the benchmark's spans", pytest.approx(45e-6)),
                           ("bench.cycle", pytest.approx(10e-6))]


def test_metric_readers_say_nothing_without_a_trace():
    m = Measured("train", "bfloat16", units=10, seconds=2.0, peak_bytes=2**31,
                 unit_work=counts.Tally(2).add([counts.Conv("a", 1, 1, 1, (1,), (1,))], 1, "fwd"))
    spec = specs.load_spec()
    values = {e["name"]: specs.reader(e["name"])(m) for e in spec["per_layer"]}
    assert values["idle_share.train"] is None and values["conv_roofline.train"] is None
    assert values["peak_gib.train"] == 2.0
    assert values["mfu.train"] == pytest.approx(100 * 10 * 2 / 2.0 / 989e12)


def test_new_cell_mix_and_metric_are_found_from_new_files(tmp_path):
    """A later change adds a cell by adding files and entries: a mix, a
    metric reader and a configuration file, found by name with no code
    edited."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "benchmark" / "configs" / "basic_3d.json").read_text())
    (root / "benchmark" / "configs" / "wide_3d.json").write_text(json.dumps({**cfg, "name": "wide_3d"}))
    (root / "benchmark" / "traffic" / "long_cycles.json").write_text(json.dumps(
        {"loop": "train_cycles", "pool_cycles": 8, "reference_cycles": 3, "in_flight": 2, "profile_cycles": 4,
         "hu": {"opt": [350, 450], "low": [150, 300], "high": [500, 650]}}))
    (root / "benchmark" / "metrics" / "copy_share.py").write_text("def read(m):\n    return 42.0\n")
    spec["configs"].append({"name": "wide_3d", "source": "https://example.org", "file": "benchmark/configs/wide_3d.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "train.wide_3d", "config": "wide_3d", "traffic": "long_cycles", "chips": 1,
                              "why": "a test"})
    spec["end_to_end"][0]["workloads"].append("train.wide_3d")
    spec["per_layer"].append({"name": "copy_share.train", "unit": "%", "better": "lower", "source": "device_trace",
                              "layer": "device", "moves": "train_samples_per_s", "workloads": ["train.wide_3d"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    loaded = specs.load_spec(root)
    cell = specs.workload(loaded, "train.wide_3d")
    assert specs.config(loaded, cell["config"], root)["name"] == "wide_3d"
    mix = specs.traffic(cell["traffic"], root / "benchmark")
    assert mix["pool_cycles"] == 8
    assert specs.loop(mix, root / "benchmark").__file__ == str(root / "benchmark" / "loops" / "train_cycles.py")
    assert [m["name"] for m in specs.per_layer(loaded, "train.wide_3d")] == ["copy_share.train"]
    assert specs.reader("copy_share.train", root / "benchmark")(None) == 42.0
    assert {m["name"] for m in specs.end_to_end(loaded, "train.wide_3d")} == {"train_samples_per_s", "setup_s"}


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and spec["command"] == ["python3", "benchmark/run.py"]
    cells = spec["workloads"]
    assert 1 <= len(cells) <= 24 and 1 <= spec["run_seconds"] <= 51
    # a full check of 24 cells (14 runs each, 2 more, compile and spare time) fits 12 hours
    assert (2 + 14 * 24) * (spec["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for e in spec[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("workloads", "end_to_end", "per_layer", "configs"):
        assert len({e["name"] for e in spec[key]}) == len(spec[key])
    configs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"] == []
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert w["config"] in configs and (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").exists()
    texts = [w["why"] for w in cells] + [c["why"] for c in spec["configs"]] + [c["source"] for c in spec["configs"]]
    texts += [m["layer"] for m in spec["per_layer"]]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert specs.reader_path(m["name"]).exists()
        for cell in m["workloads"]:
            assert cell in {w["name"] for w in cells}
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for w in cells:  # every cell reports setup_s, another end-to-end metric and a per-layer one
        assert len(specs.end_to_end(spec, w["name"])) >= 2 and specs.per_layer(spec, w["name"])
    assert len(json.dumps(spec)) <= 64 * 1024


def test_run_without_a_card_exits_2_and_prints_nothing():
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "train.basic_3d", "--seed",
                           str(2**31 + 9), "--seconds", "1"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    if proc.returncode == 0:
        pytest.skip("this machine has a card: the refusal is for machines without one")
    assert proc.returncode == 2 and proc.stdout == ""
    assert "needs 1 CUDA device" in proc.stderr


def test_run_refuses_a_process_that_loaded_jax(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "contrast_gan_3d_tpu", object())
    assert run.banned_modules() == ["contrast_gan_3d_tpu", "jax"]
    monkeypatch.delitem(sys.modules, "jax.numpy")
    monkeypatch.delitem(sys.modules, "contrast_gan_3d_tpu")
    assert "contrast_gan_3d_tpu_torch" not in run.banned_modules()


def test_process_age_counts_from_the_process_start():
    from benchmark import run

    assert 0 < run.process_age_s() < 24 * 3600 and math.isfinite(run.process_age_s())
