"""The port's CLI flags and tools of this slice, on the CPU: the train CLI's
``--cycle-length``, ``--debug``, ``--profiler-*``, ``--dp-devices`` and
``--sp-devices`` against the JAX CLI's parser, their usage errors, the
finite check, ``memory_report --tiny``, ``correct_scans --sharded`` and
``train --sp-devices 2`` against the one-rank run. Tiny sizes: the fit
tests' patients and override file (16^3 patches, narrow networks)."""

import json
import logging
import pickle
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

import train as jax_train_cli
from contrast_gan_3d_tpu_torch import correct_scans, memory_report
from contrast_gan_3d_tpu_torch import train as train_cli
from contrast_gan_3d_tpu_torch.eval.corrector import CCTAContrastCorrector
from contrast_gan_3d_tpu_torch.experiments import builder
from contrast_gan_3d_tpu_torch.eval.utils import device_int16, load_patient_or_scan
from contrast_gan_3d_tpu_torch.utils.debug import check_finite
from contrast_gan_3d_tpu_torch.utils import memory as memory_lib
from contrast_gan_3d_tpu_torch.utils.io_utils import read_image
from tests.test_torch_port_fit import OVERRIDE, fold  # noqa: F401  (a fixture)
from tests.test_torch_port_multihost import OVERRIDE as MESH_OVERRIDE
from tests.test_torch_port_multihost import _patients
from tests.test_torch_port_serving_files import _port_checkpoint, cohort  # noqa: F401  (a fixture)


def _args(tmp_path, fold, *extra):
    conf, splits = tmp_path / "tiny.py", tmp_path / "splits.pkl"
    conf.write_text(OVERRIDE)
    splits.write_bytes(pickle.dumps({"train": [fold], "test": [fold]}))
    return ["--conf", str(conf), "--cval-splits", str(splits), "--checkpoint-root", str(tmp_path / "runs"),
            "--run-id", "r", "--device", "cpu", "--iterations", "2", *extra]


@pytest.mark.parametrize("flags", [
    ["--cycle-length", "2"], ["--debug"], ["--profiler-dir", "P", "--profiler-steps", "3"],
    ["--profiler-dir", "P", "--profiler-schedule", "skip_first=1,active=2"], ["--dp-devices", "2"],
    ["--multihost"], ["--dp-devices", "2", "--sp-devices", "2"],
])
def test_train_flags_parse_as_the_jax_cli_parses_them(tmp_path, flags):
    base = ["--cval-splits", "s.pkl", "--checkpoint-root", "r"]
    got, want = vars(train_cli.parse_args(base + flags)), vars(jax_train_cli.parse_args(base + flags))
    for k in ("cycle_length", "debug", "profiler_dir", "profiler_steps", "profiler_schedule", "dp_devices",
              "sp_devices", "multihost"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("bad", [["--dp-devices", "-1"], ["--dp-devices", "0", "--device", "cpu"],
                                 ["--sp-devices", "0"]])
def test_train_dp_devices_usage_errors(bad):
    with pytest.raises(SystemExit):
        train_cli.parse_args(["--cval-splits", "s.pkl", "--checkpoint-root", "r", *bad])


@pytest.mark.parametrize("flags,visible", [(["--dp-devices", "0", "--sp-devices", "2"], 1),
                                           (["--dp-devices", "2", "--sp-devices", "2"], 2),
                                           (["--sp-devices", "2"], 1)])
def test_train_refuses_more_ranks_than_cards(tmp_path, monkeypatch, flags, visible):
    """Without a launcher on cards, ``D x S`` ranks must be at least S and
    at most the visible cards: the command stops with a usage error and
    starts no rank (``--dp-devices 0`` with fewer cards than S would start
    none and train nothing)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    spawned = []
    monkeypatch.setattr(train_cli, "spawn_ranks", lambda *a, **k: spawned.append(a))
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(SystemExit, match="ranks"):
        train_cli.main(_args(tmp_path, "unused", *flags, "--device", "cuda"))
    assert not spawned


def test_cycle_length_reaches_the_trainer(fold, tmp_path):  # noqa: F811
    """The override file's cadences (2 and 3) make ``auto`` resolve to 1;
    ``--cycle-length 2`` forces 2-iteration cycles."""
    auto = train_cli.main(_args(tmp_path, fold, "--run-id", "auto"))
    forced = train_cli.main(_args(tmp_path, fold, "--cycle-length", "2"))
    assert auto.runs[0].trainer.cfg.cycle_length == 1 and auto.config.cycle_length is None
    assert forced.config.cycle_length == 2 and forced.runs[0].trainer.cfg.cycle_length == 2
    assert forced.runs[0].trainer.iteration == 2


def test_debug_dispatches_eagerly_and_says_so(fold, tmp_path, caplog):  # noqa: F811
    before = torch.is_anomaly_enabled()
    with caplog.at_level(logging.WARNING, logger="contrast_gan_3d_tpu_torch.train"):
        manager = train_cli.main(_args(tmp_path, fold, "--cycle-length", "2", "--debug"))
    trainer = manager.runs[0].trainer
    assert trainer.cfg.cycle_length == 1 and trainer.cycle_dispatch == "eager"
    assert any("--debug" in r.message and "cycle_length 2 -> 1" in r.getMessage() for r in caplog.records)
    assert torch.is_anomaly_enabled() == before  # restored when the command returns


def test_check_finite_names_the_iteration():
    check_finite({"D": torch.tensor(1.0)}, 3)
    with pytest.raises(FloatingPointError, match="iteration 7.*'G'"):
        check_finite({"D": torch.tensor(1.0), "G": torch.tensor(float("nan"))}, 7)


@pytest.mark.parametrize("flags,traces", [(["--profiler-steps", "2"], 1),
                                          (["--profiler-schedule", "skip_first=1,active=1"], 1)])
def test_profiler_writes_traces(fold, tmp_path, flags, traces, monkeypatch):  # noqa: F811
    """A Chrome trace per window, and after it the live-block table and the
    heap profile of the allocator's history recorded over the window. The
    CPU has no allocator history: the card's recording and dump are
    stood in for by fakes that log their order (the card runs the real
    ones: ``chip_smoke.py``'s memory phase)."""
    events = []

    def record(enabled=True, max_entries=0):
        events.append("start" if enabled else "stop")
        return True

    def dump(path):
        events.append("dump")
        Path(path).write_bytes(b"snapshot")
        return True

    monkeypatch.setattr(memory_lib, "record_memory_history", record)
    monkeypatch.setattr(memory_lib, "dump_heap_profile", dump)
    out = tmp_path / "prof"
    train_cli.main(_args(tmp_path, fold, "--profiler-dir", str(out), *flags))
    assert len(list(out.glob("*.pt.trace.json"))) == traces
    tables, profiles = list(out.glob("memory_step*.txt")), list(out.glob("memory_step*.pickle"))
    assert len(tables) == len(profiles) == traces and profiles[0].read_bytes() == b"snapshot"
    assert events == ["start", "dump", "stop"] * traces
    with pytest.raises(ValueError, match="unknown key"):
        train_cli.make_profiler(out, schedule="skip=1")


def test_memory_report_tiny_on_the_cpu(tmp_path):
    """JAX's seven programs by JAX's names, the last two each a pair of
    gloo ranks (one row with each rank's figures): the (1, 2) dp x sp
    ranks pass the whole 4 + 4 patches and keep their slabs, the (2, 1)
    dp ranks pass 2 + 2 each."""
    rows = memory_report.main(["--out", str(tmp_path), "--tiny", "--device", "cpu"])
    assert [r["program"] for r in rows] == list(memory_report.PROGRAMS) == \
        ["corrector", "train", "train_gp", "train96", "cycle5", "gp96_sp2", "gp96_dp2"]
    assert [r["name"].split(" ")[0] for r in rows] == ["packed", "combined_step", "combined_step", "combined_step",
                                                      "5-iteration", "combined_step", "combined_step"]
    single = [r for r in rows if "ranks" not in r]
    assert len(single) == 5 and all(r["fits"] and r["peak_bytes"] is None and r["argument_bytes"] > 0
                                    for r in single)
    sp2, dp2 = rows[5:]
    assert sp2["mesh"] == [1, 2] and dp2["mesh"] == [2, 1]
    for row in (sp2, dp2):
        assert row["fits"] and [r["rank"] for r in row["ranks"]] == [0, 1]
        assert all(r["peak_bytes"] is None and r["seconds"] > 0 for r in row["ranks"])
    # a dp rank holds half the patches the sp ranks hold whole
    assert dp2["ranks"][0]["argument_bytes"] < sp2["ranks"][0]["argument_bytes"]
    saved = json.loads((tmp_path / "memory_report.json").read_text())
    assert saved["card"] == "CPU" and len(saved["rows"]) == 7
    text = (tmp_path / "memory_report.md").read_text()
    assert "not measured" in text and all(f"`{name}`" in text for name in memory_report.PROGRAMS)


def test_memory_report_programs_flag(tmp_path, capsys):
    """``--programs`` takes a comma list of JAX's names (and ``gp96``, the
    one-rank reference of the mesh programs) and refuses any other."""
    rows = memory_report.main(["--out", str(tmp_path), "--tiny", "--device", "cpu", "--programs",
                               "train, gp96"])
    assert [r["program"] for r in rows] == ["train", "gp96"]
    for bad in ("train,gp192", "", "skip-run"):
        with pytest.raises(SystemExit):
            memory_report.main(["--out", str(tmp_path), "--tiny", "--device", "cpu", "--programs", bad])
        assert "unknown program" in capsys.readouterr().err


def test_correct_scans_sharded_equals_unsharded(cohort, tmp_path):  # noqa: F811
    """``--sharded`` on the CPU (one share, the masked grid) writes what the
    corrector's ``shard_over`` gives; where the scan's dims are multiples
    of 4 that is the unsharded file up to the order of the sums (int16
    within 1 HU). Elsewhere the sharded packed grid pads at the high end,
    as JAX's does, and the files differ."""
    paths, gen = cohort
    _port_checkpoint(gen, tmp_path / "ckpt")
    common = [str(tmp_path / "ckpt"), "--patch-size", "16", "16", "16", "--batch-size", "3", "--device", "cpu"]
    plain = correct_scans.main([common[0], str(tmp_path / "plain"), *map(str, paths), *common[1:]])
    sharded = correct_scans.main([common[0], str(tmp_path / "sharded"), *map(str, paths), *common[1:],
                                  "--sharded"])
    corrector = CCTAContrastCorrector.from_checkpoint(tmp_path / "ckpt", inference_patch_size=(16, 16, 16),
                                                      batch_size=3, device="cpu").shard_over(["cpu"])
    aligned = 0
    for src, a, b in zip(paths, plain, sharded):
        vol = load_patient_or_scan(src)[0]
        np.testing.assert_array_equal(read_image(b)[0], device_int16(corrector(vol)).numpy())
        if all(d % 4 == 0 for d in vol.shape):
            aligned += 1
            diff = np.abs(read_image(a)[0].astype(np.int32) - read_image(b)[0].astype(np.int32))
            assert diff.max() <= 1, (a, diff.max())
    assert aligned


def test_train_sp_devices_logs_the_one_rank_losses(tmp_path, monkeypatch):
    """``--sp-devices 2`` on the CPU: the command starts two gloo ranks, each
    training on its X-slab of the batches the one-rank run loads (the
    direct layout in both runs; one intra-op thread each). Every logged
    train and validation loss is within JAX's dp x sp metric tolerance
    (``tests/test_parallel.py``: rtol 2e-4, atol 1e-5) of the one-rank
    run's, and rank 0 writes the checkpoint of the replicated weights."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    fold = _patients(tmp_path / "patients")
    conf, splits = tmp_path / "tiny.py", tmp_path / "splits.pkl"
    # no images in either run: a mesh of ranks logs none, so the one-rank
    # run's time budget would carry an images window the ranks' lack
    conf.write_text(MESH_OVERRIDE.replace('logger="file")',
                                          'logger="file", generator_layout="direct", log_images_every=None)'))
    splits.write_bytes(pickle.dumps({"train": [fold], "test": [fold]}))
    args = lambda run_id: ["--conf", str(conf), "--cval-splits", str(splits), "--checkpoint-root",
                           str(tmp_path / "runs"), "--run-id", run_id, "--device", "cpu", "--iterations", "4"]
    one = train_cli.main(args("one"))
    assert one.runs[0].trainer.state.generator.layout == "direct"
    assert train_cli.main(args("sp") + ["--sp-devices", "2"]) is None
    logged = {run: [json.loads(line) for line in (tmp_path / "runs" / run / "metrics" / "scalars.jsonl")
                    .read_text().splitlines()] for run in ("one", "sp")}
    assert [(r["stage"], r["iteration"]) for r in logged["sp"]] == [(r["stage"], r["iteration"]) for r in
                                                                     logged["one"]]
    assert {r["stage"] for r in logged["one"]} == {"train", "validation"}
    compared = set()
    for got, want in zip(logged["sp"], logged["one"]):
        assert set(got) == set(want)
        losses = {k for k in want if k in ("D", "G", "G-full", "sim", "HU")}
        compared |= losses
        for k in losses:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=1e-5, err_msg=f"{want['stage']} "
                                                                                       f"{want['iteration']} {k}")
    assert compared == {"D", "G", "G-full", "sim", "HU"}
    assert sorted(p.name for p in (tmp_path / "runs" / "sp").glob("*.pt")) == \
        sorted(p.name for p in (tmp_path / "runs" / "one").glob("*.pt"))


def test_train_sp_devices_trains_the_packed_layout(tmp_path, monkeypatch):
    """``--sp-devices 2`` on the CPU with the layout "auto" resolves to: the
    packed generator, as without a mesh (slabs of 8 rows, whole f4 blocks
    at every stage), each rank on its slab. Every logged loss is within
    JAX's dp x sp metric tolerance of the one-rank packed run's, and the
    checkpoints are the one-rank run's."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    fold = _patients(tmp_path / "patients")
    conf, splits = tmp_path / "tiny.py", tmp_path / "splits.pkl"
    conf.write_text(MESH_OVERRIDE)
    splits.write_bytes(pickle.dumps({"train": [fold], "test": [fold]}))
    args = lambda run_id: ["--conf", str(conf), "--cval-splits", str(splits), "--checkpoint-root",
                           str(tmp_path / "runs"), "--run-id", run_id, "--device", "cpu", "--iterations", "4"]
    one = train_cli.main(args("one"))
    assert one.runs[0].trainer.state.generator.layout == "packed"
    sp_cfg = replace(one.config, sp_devices=2)
    assert builder.resolve_layout(sp_cfg) == "packed"  # what each rank builds
    assert train_cli.main(args("sp") + ["--sp-devices", "2"]) is None
    logged = {run: [json.loads(line) for line in (tmp_path / "runs" / run / "metrics" / "scalars.jsonl")
                    .read_text().splitlines()] for run in ("one", "sp")}
    assert [(r["stage"], r["iteration"]) for r in logged["sp"]] == [(r["stage"], r["iteration"]) for r in
                                                                     logged["one"]]
    for got, want in zip(logged["sp"], logged["one"]):
        for k in {"D", "G", "G-full", "sim", "HU"} & set(want):
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=1e-5, err_msg=f"{want['stage']} "
                                                                                       f"{want['iteration']} {k}")
    assert sorted(p.name for p in (tmp_path / "runs" / "sp").glob("*.pt")) == \
        sorted(p.name for p in (tmp_path / "runs" / "one").glob("*.pt"))
