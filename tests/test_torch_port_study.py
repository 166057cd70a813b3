"""The study tools of the port against the JAX package's, on the CPU: marker
recall (``eval/marker_recall_rate.py``), the synthetic tracker and the
recall command, ``create_dataset``, ``eval_overlap_quality``,
``flops_accounting`` with the block-conv operators' flop formulas, and the
train CLI's fallback to folds from ``dataset_paths``.

Tolerances: recall distances, recall, the tracker's points and files, the
recall JSON, the sheets' ID / path / label / order and the folds are
exact. ``create_dataset``'s (mu, std) within 0.1 HU: the port samples the
ostia patches in f32 (``ops/resample.sample_world_patch``), JAX on the
host in f64. ``synth_patient`` is bit-equal. The FLOP counts are exact
integers: each equals an analytic sum of 2 x multiply-adds over the
recorded convolutions, contractions and block-conv launches (a forward;
a forward and a backward)."""

import importlib.util
import json
import logging
import math
import pickle
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from contrast_gan_3d_tpu.data import labeling as jax_lab
from contrast_gan_3d_tpu.data import preprocess as jax_pre
from contrast_gan_3d_tpu.eval import marker_recall_rate as jax_mrr
from contrast_gan_3d_tpu_torch import (
    create_dataset,
    eval_marker_recall,
    eval_overlap_quality,
    flops_accounting,
    synthetic_tracker,
    validate_learning,
)
from contrast_gan_3d_tpu_torch import train as train_cli
from contrast_gan_3d_tpu_torch.data import labeling as lab
from contrast_gan_3d_tpu_torch.eval import marker_recall_rate as mrr
from contrast_gan_3d_tpu_torch.experiments.config import load_config
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.ops import block_conv

REPO = Path(__file__).resolve().parents[1]
HU_TOL = 0.1


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax(monkeypatch, name, *argv):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *map(str, argv)])
    _jax_script(name).main()


# --- marker recall ---------------------------------------------------------------------------------------------


def _recall_tree(root: Path):
    """Centerlines and IDR_CADRADS annotations: LAD on the line (recall 1),
    RCA 10 mm off (recall 0); ``pc``'s centerline file is malformed,
    ``ghost`` has no files, ``p1`` only a substring hit (``p10``)."""
    rows = [("pa", 0), ("pb", -1), ("pc", 1), ("ghost", 1), ("p1", 0)]
    for name in ("pa", "pb", "pc", "p10"):
        pdir, adir = root / "ctls" / name, root / "annots" / name
        pdir.mkdir(parents=True)
        adir.mkdir(parents=True)
        pts = np.stack([np.linspace(0, 9, 10)] * 3, -1)
        np.savetxt(pdir / "vessel0.txt", np.concatenate([pts, np.ones((10, 1))], -1))
        np.savetxt(adir / "LAD.txt", pts[:4] + 0.3 * (name == "p10"))
        np.savetxt(adir / "RCA.txt", pts[:4] + np.array([10.0, 0, 0]))
    (root / "ctls" / "pc" / "vessel0.txt").write_text("1 2 3 4\n5 6 7\n")
    return [{"ID": n, "label": lbl} for n, lbl in rows]


def _same_distances(got: dict, want: dict):
    assert {k.name: set(v) for k, v in got.items()} == {k.name: set(v) for k, v in want.items()}
    for st, per_artery in want.items():
        for artery, dd in per_artery.items():
            port = got[next(k for k in got if k.name == st.name)][artery]
            for key in ("z_idx", "dist"):
                np.testing.assert_array_equal(port[key], dd[key])


def test_marker_recall_matches_jax(tmp_path, caplog):
    rows = _recall_tree(tmp_path)
    want_d, want_m = jax_mrr.eval_model_marker_recall_rate(tmp_path / "ctls", tmp_path / "annots",
                                                           pd.DataFrame(rows), workers=2)
    with caplog.at_level(logging.WARNING):
        got_d, got_m = mrr.eval_model_marker_recall_rate(tmp_path / "ctls", tmp_path / "annots", rows, workers=2)
    _same_distances(got_d, want_d)
    assert {k.name: v for k, v in got_m.items()} == {k.name: v for k, v in want_m.items()}
    assert mrr.summarize_marker_recall_rate(got_d) == jax_mrr.summarize_marker_recall_rate(want_d)
    text = caplog.text
    assert "ghost" in text and "EXCLUDED" in text and "FAILED" in text and "No exact match" in text


@pytest.mark.parametrize("dist", [[0.0, 4.9, 5.0, 5.1, 100.0], [], [7.0], [5.0, 5.000001]])
def test_marker_recall_rate_matches_jax(dist):
    got, want = mrr.marker_recall_rate(np.array(dist)), jax_mrr.marker_recall_rate(np.array(dist))
    assert got == want or (math.isnan(got) and math.isnan(want))


def test_annotation_readers_match_jax(tmp_path):
    f = tmp_path / "annot.txt"
    f.write_text("m1 1.0 2.0 3.0\nm2 4.0 5.0 6.0\n")
    np.testing.assert_array_equal(mrr.read_ASOCA_annotations(f)["centerlines"],
                                  jax_mrr.read_ASOCA_annotations(f)["centerlines"])
    np.savetxt(tmp_path / "LAD.txt", np.arange(12.0).reshape(4, 3))
    np.savetxt(tmp_path / "RCA.txt", np.arange(6.0).reshape(2, 3))
    got, want = mrr.read_IDR_CADRADS_annotations(tmp_path), jax_mrr.read_IDR_CADRADS_annotations(tmp_path)
    assert set(got) == set(want) == {"LAD", "RCA"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.fixture(scope="module")
def raw_cohort(tmp_path_factory):
    """An eval_hu_shift cohort list of synthetic raw scans (validate_learning's
    raw layout): OPT and HIGH vessels above the tracker's 300 HU, LOW below."""
    root = tmp_path_factory.mktemp("cohort")
    rng = np.random.default_rng(5)
    entries = []
    for name, hu, label in (("opt_0", 400, 0), ("low_0", 250, -1), ("high_0", 550, 1), ("opt_1", 400, 0)):
        _, _, scan, pdir = validate_learning.write_raw(rng, (20, 20, 20), root, name, hu)
        entries.append([[str(scan), str(pdir), None], label])
    cohort = root / "list.json"
    cohort.write_text(json.dumps(entries))
    return cohort


def test_tracker_and_recall_commands_match_jax(tmp_path, monkeypatch, raw_cohort):
    """The tracker's files are the JAX script's byte for byte (points
    subsampled by the same draws), and so is the recall command's JSON."""
    out = {}
    for side in ("jax", "port"):
        argv = [raw_cohort, tmp_path / side / "tracked", "--annotations-out", tmp_path / side / "annots",
                "--max-points", "60", "--seed", "3"]
        if side == "jax":
            _run_jax(monkeypatch, "synthetic_tracker", *argv)
        else:
            summary = synthetic_tracker.main([*map(str, argv), "--device", "cpu"])
            assert len(summary["points"]["low_0"]) == 0 and len(summary["points"]["opt_0"]) == 60
        out[side] = tmp_path / side
    files = sorted(p.relative_to(out["jax"]) for p in out["jax"].rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(out["port"]) for p in out["port"].rglob("*") if p.is_file())
    assert len(files) == 4 + 4 * 3 + 1
    for f in files:
        assert (out["port"] / f).read_bytes() == (out["jax"] / f).read_bytes(), f
    for side in ("jax", "port"):
        argv = [out[side] / "tracked", out[side] / "annots", out[side] / "annots" / "labels.csv",
                out[side] / "recall.json", "--workers", "2"]
        if side == "jax":
            _run_jax(monkeypatch, "eval_marker_recall", *argv)
        else:
            payload = eval_marker_recall.main(list(map(str, argv)))
            assert payload["summary"]["optimal"]["LAD"] == 1.0
            # nothing tracked on the LOW scan: its markers are not scored
            assert "LOW" not in payload["per_scan_type"]
    assert (out["port"] / "recall.json").read_text() == (out["jax"] / "recall.json").read_text()


def test_tracker_threshold_is_exact_for_fractional_thresholds(tmp_path, raw_cohort):
    """A voxel of exactly 300 HU tracks above 299.9999999 (the f64
    comparison), whatever precision the device compares in."""
    scan = json.loads(raw_cohort.read_text())[0][0][0]
    vol, _ = synthetic_tracker.io_utils.load_scan(scan)
    want = np.argwhere(vol > 299.9999999)
    got = synthetic_tracker.track_scan(scan, 299.9999999, 10**9, np.random.default_rng(0), device="cpu")
    assert len(got) == len(want) > 0


# --- create_dataset --------------------------------------------------------------------------------------------


def _patients(root: Path, rng):
    """Preprocessed patients (0.5 mm), each an aortic-root lumen of its
    label's HU (220 LOW, 400 OPT, 600 HIGH) around one ostium in soft
    tissue, the other ostium in the tissue's edge."""
    labels = {}
    for i, (hu, label) in enumerate([(220, -1), (400, 0), (600, 1)] * 3):
        shape = (28, 26, 24)
        vol = rng.normal(40, 25, shape)
        grid = np.stack(np.meshgrid(*[np.arange(n) for n in shape], indexing="ij"), -1)
        lumen = np.linalg.norm(grid - np.array([12, 13, 11]), axis=-1) < 5
        vol[lumen] = rng.normal(hu, 18, lumen.sum())
        meta = {"spacing": np.full(3, 0.5), "offset": np.array([-3.0, 2.0, 10.0]),
                "ostia_world": np.array([[3.0, 8.5, 15.5], [5.5, 7.0, 16.0]], np.float32),
                "centerlines_world": np.zeros((0, 4), np.float32)}
        name = f"case{(7 * i) % 9}"
        jax_pre.write_patient(vol.astype(np.int16), np.zeros(shape, np.uint8), meta, name, root)
        labels[name] = label
    return labels


def test_create_dataset_matches_jax(tmp_path, monkeypatch):
    labels = _patients(tmp_path / "patients", np.random.default_rng(11))
    _run_jax(monkeypatch, "create_dataset", tmp_path / "patients", tmp_path / "jax", "--n-folds", "3")
    result = create_dataset.main([str(tmp_path / "patients"), str(tmp_path / "port"), "--n-folds", "3",
                                  "--device", "cpu"])
    want = pd.read_csv(tmp_path / "jax" / "dataset.csv").to_dict("records")
    got = lab.read_sheet(tmp_path / "port" / "dataset.csv")
    assert [(r["ID"], r["path"], r["label"]) for r in got] == [(r["ID"], r["path"], r["label"]) for r in want]
    assert {r["ID"]: r["label"] for r in got} == labels
    for g, w in zip(got, want):
        assert abs(g["mu"] - w["mu"]) <= HU_TOL and abs(g["std"] - w["std"]) <= HU_TOL, (g, w)
    with open(tmp_path / "jax" / "cross_val_splits.pkl", "rb") as fd:
        jax_splits = pickle.load(fd)
    with open(tmp_path / "port" / "cross_val_splits.pkl", "rb") as fd:
        port_splits = pickle.load(fd)
    norm = lambda folds: [[(str(p), int(lbl)) for p, lbl in fold] for fold in folds]
    assert port_splits == {k: norm(v) for k, v in jax_splits.items()}
    assert result["rows"] == got and result["patients"] == 9


def test_create_dataset_refuses_hdf5(tmp_path):
    """HDF5 patients were refused until HDF5 was ported; now a raw HDF5
    scan (never preprocessed) is refused, as the JAX script refuses it,
    and so is a directory without patients."""
    from contrast_gan_3d_tpu_torch.utils.io_utils import write_hdf5_image

    write_hdf5_image(np.zeros((6, 6, 4), np.int16), tmp_path / "c.h5")
    with pytest.raises(SystemExit, match="preprocess"):
        create_dataset.main([str(tmp_path), str(tmp_path / "out"), "--device", "cpu"])
    with pytest.raises(SystemExit, match="no preprocessed patients"):
        create_dataset.main([str(tmp_path / "empty"), str(tmp_path / "out"), "--device", "cpu"])


# --- eval_overlap_quality --------------------------------------------------------------------------------------


@pytest.mark.parametrize("shape,n_points", [((24, 20, 16), None), ((40, 32, 24), None), ((20, 20, 20), 7)])
def test_overlap_synth_patient_matches_jax(shape, n_points):
    jax_synth = _jax_script("eval_overlap_quality").synth_patient
    want = jax_synth(np.random.default_rng(4), shape, 250, n_points)
    got = eval_overlap_quality.synth_patient(np.random.default_rng(4), shape, 250, n_points)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    assert set(got[2]) == set(want[2])
    for k in want[2]:
        np.testing.assert_array_equal(got[2][k], want[2][k])


def test_overlap_metrics_match_jax():
    """The JAX script's metrics block (``scripts/eval_overlap_quality.py``,
    the pairwise deltas of ``main``), restated here on the same arrays."""
    rng = np.random.default_rng(1)
    by = {o: rng.normal(300, 40, (12, 10, 8)).astype(np.float32) for o in (0.0, 0.25, 0.5)}
    m = rng.random((12, 10, 8)) < 0.2
    want = {}
    for (a, b) in ((0.25, 0.5), (0.0, 0.25)):
        tag = f"{int(a * 100)}_vs_{int(b * 100)}"
        d = np.abs(by[a] - by[b])
        want[f"abs_delta_{tag}_hu"] = {
            "mean": round(float(d.mean()), 3), "p99": round(float(np.percentile(d, 99)), 3),
            "max": round(float(d.max()), 3), "centerline_mean": round(float(d[m].mean()), 3),
            "centerline_max": round(float(d[m].max()), 3)}
        want[f"centerline_delta_{tag}_hu"] = round(abs(float(by[a][m].mean()) - float(by[b][m].mean())), 3)
    assert eval_overlap_quality.overlap_metrics(by, m) == want


TINY_3D = dict(train_patch_size=(16, 16, 16), val_patch_size=(16, 16, 16), train_batch_size={0: 2, -1: 1, 1: 1},
               generator_args={"n_resnet_blocks": 1, "n_updownsample_blocks": 1, "init_channels_out": 4},
               critic_args={"init_channels_out": 4, "discriminator_depth": 2, "negative_slope": 0.2},
               augment_backend="device")


@pytest.mark.parametrize("iterations", [0, 2])
def test_overlap_quality_cli(monkeypatch, tmp_path, iterations):
    from dataclasses import replace

    monkeypatch.setattr(eval_overlap_quality, "load_config", lambda name: replace(load_config(name), **TINY_3D))
    monkeypatch.setattr(eval_overlap_quality, "EVAL_PATCH", (16, 16, 16))
    out = eval_overlap_quality.main(["--iterations", str(iterations), "--train-shape", "24", "24", "24",
                                     "--eval-shape", "32", "32", "24", "--batch", "2", "--device", "cpu",
                                     "--out", str(tmp_path / "o.json")])
    jax_keys = {"train_seconds", "iterations", "eval_shape", "centerline_mean_hu_before",
                "background_mean_hu_before", "target_corridor", "overlaps", "abs_delta_25_vs_50_hu",
                "centerline_delta_25_vs_50_hu", "abs_delta_0_vs_25_hu", "centerline_delta_0_vs_25_hu"}
    assert jax_keys | {"card"} == set(out) and out["card"] == "cpu"
    assert json.loads((tmp_path / "o.json").read_text()) == out
    assert set(out["overlaps"]) == {"0.0", "0.25", "0.5"}
    for r in out["overlaps"].values():
        assert all(math.isfinite(r[k]) for k in ("centerline_mean_hu_after", "background_mean_hu_after"))
    assert out["iterations"] == iterations and (out["train_seconds"] > 0) == (iterations > 0)


# --- flops_accounting ------------------------------------------------------------------------------------------


class _Recorder:
    """2 x multiply-adds of every conv, einsum, B1 / B3 launch and B1
    weight gradient a call makes, from their shapes; ``backward=True``
    adds what a backward of every conv and einsum computes: the weight's
    gradient, and the input's where the input needs one (each as many
    multiply-adds as the forward). B1's backward launches and weight
    gradients are calls of their own."""

    def __init__(self, monkeypatch):
        self.fwd, self.bwd, self._inner = 0, 0, 0
        for mod in (F, torch):
            for name in ("conv3d", "conv2d", "conv_transpose3d", "conv_transpose2d"):
                monkeypatch.setattr(mod, name, self._conv(getattr(mod, name), "transpose" in name))
        monkeypatch.setattr(torch, "einsum", self._einsum(torch.einsum))
        monkeypatch.setattr(block_conv, "block_conv_op", self._b1(block_conv.block_conv_op))
        monkeypatch.setattr(block_conv, "weight_grad", self._wgrad(block_conv.weight_grad))
        monkeypatch.setattr(block_conv, "s2d_conv3d_block_op", self._b3(block_conv.s2d_conv3d_block_op))

    def _add(self, macs, grads):
        if not self._inner:
            self.fwd += 2 * macs
            self.bwd += 2 * macs * sum(bool(g) for g in grads)

    def _conv(self, fn, transposed):
        def conv(x, w, *args, **kwargs):
            out = fn(x, w, *args, **kwargs)
            spatial = x.shape[2:] if transposed else out.shape[2:]
            self._add(out.shape[0] * math.prod(spatial) * w.numel(), (x.requires_grad, w.requires_grad))
            return out
        return conv

    def _einsum(self, fn):
        def einsum(eq, *ops):
            sizes = {}
            for term, t in zip(eq.split("->")[0].split(","), ops):
                sizes.update(zip(term, t.shape))
            self._add(math.prod(sizes.values()), [t.requires_grad for t in ops])
            return fn(eq, *ops)
        return einsum

    def _b1(self, fn):
        def b1(x, w_km, layout):
            b, z, d2, d3 = x.shape[:4]
            self._add(b * (z - 2) * (d2 - 2) * (d3 - 2) * 27 * w_km.shape[2] * w_km.shape[1], ())
            return self._opaque(fn, x, w_km, layout)
        return b1

    def _wgrad(self, fn):
        def wgrad(x, dy, layout="zxy"):
            self._add(27 * math.prod(dy.shape[:4]) * x.shape[-1] * dy.shape[-1], ())
            return fn(x, dy, layout)
        return wgrad

    def _b3(self, fn):
        def b3(x, w, bias, f, padding_mode):
            kx, ky, kz, ci, co = w.shape
            blocks = [(d + 2 * ((k - 1) // 2)) // f + (1 if (d + 2 * ((k - 1) // 2)) % f else 0)
                      for d, k in zip(x.shape[1:4], (kx, ky, kz))]
            blocks = [max(nb, d // f + 2) for nb, d in zip(blocks, x.shape[1:4])]
            self._add(x.shape[0] * math.prod(nb - 2 for nb in blocks) * 27 * f**3 * ci * f**3 * co, ())
            return self._opaque(fn, x, w, bias, f, padding_mode)
        return b3

    def _opaque(self, fn, *args):
        """An operator's own body (the plain versions' einsums) is not
        counted: ``FlopCounterMode`` sees the operator alone."""
        self._inner += 1
        try:
            return fn(*args)
        finally:
            self._inner -= 1


@pytest.mark.parametrize("layout", ["packed", "direct"])
def test_flops_count_equals_analytic_sum(monkeypatch, layout):
    """The inference forward (eval, no gradient) and a generator forward
    and backward, as ``flops_accounting`` counts them, equal the recorded
    analytic sums."""
    rec = _Recorder(monkeypatch)
    fwd, _ = flops_accounting.setup_forward(layout, torch.device("cpu"), smoke=True)
    with torch.no_grad():
        counted = flops_accounting.count(fwd, torch.device("cpu"))
    assert counted["flops"] == rec.fwd > 0
    if layout == "direct":
        assert counted["kernels"]["s2d_conv3d_block"]["calls"] == 2
        assert counted["model_flops"] < counted["flops"]
    torch.manual_seed(0)
    gen = ResnetGenerator(layout=layout, **flops_accounting.SMOKE_GEN)
    x = torch.randn(2, 1, 16, 16, 16)
    rec.fwd = rec.bwd = 0
    counted = flops_accounting.count(lambda: gen(x).sum().backward(), torch.device("cpu"))
    assert counted["flops"] == rec.fwd + rec.bwd
    if layout == "direct":
        # stem and projection forward, the projection's dx (the stem's input
        # needs none), both weight gradients
        assert {k: v["calls"] for k, v in counted["kernels"].items()} == {"block_conv3x3x3": 3, "weight_grad": 2}


def test_flops_accounting_smoke():
    out = flops_accounting.main(["--smoke", "--json", "--device", "cpu"])
    assert set(flops_accounting.JAX_HLO_TFLOP) < set(out)
    assert {k for k in out if k.endswith("_direct") or "direct" in k} == {
        "combined_wc_128c_b12_direct", "critic_only_128c_b12_direct", "combined_gp_128c_b12_direct",
        "inference_fwd_direct_128c_b24"}
    for name, r in out.items():
        assert r["flops"] > 0 and r["model_flops"] <= r["flops"]
        assert r["jax_hlo_tflop"] == flops_accounting.JAX_HLO_TFLOP.get(name)
        # the packed programs launch no block conv; the direct ones do
        assert bool(r["kernels"]) == ("direct" in name)
    calls = lambda name: {k: v["calls"] for k, v in out[name]["kernels"].items()}
    assert calls("combined_wc_128c_b12_direct") == {"block_conv3x3x3": 3, "weight_grad": 2}
    assert calls("critic_only_128c_b12_direct") == {"s2d_conv3d_block": 2}


def test_b1_formula_is_the_bound_count():
    """B1's formula is the count behind chip_smoke's B1 bound: 2 B
    (Z-2)(X-2)(Y-2) 27 Ci Co at the batch-8 34^3 stem and projection; a
    counted launch equals it, the dx launch through the operator too."""
    for ci, co in ((64, 1024), (1024, 64)):
        blocks = (34, 34, 34)
        want = 2 * 8 * math.prod(b - 2 for b in blocks) * 27 * ci * co
        assert block_conv.block_conv_flops((8, *blocks, ci), (27, co, ci)) == want
    x = torch.randn(2, 6, 5, 7, 3, requires_grad=True)
    w = torch.randn(3, 3, 3, 3, 5, requires_grad=True)
    mode = FlopCounterMode(display=False)
    with mode:
        y = block_conv.block_conv3x3x3(x, w)
    op = torch.ops.contrast_gan_3d_torch.block_conv3x3x3
    fwd = block_conv.block_conv_flops(x.shape, (27, 5, 3))
    assert mode.get_flop_counts()["Global"] == {op: fwd}
    with mode:
        y.sum().backward()
    # the dx launch on dy padded by 2 (Co -> Ci), and dw's 27 products
    dx = block_conv.block_conv_flops((2, 8, 7, 9, 5), (27, 3, 5))
    counts = mode.get_flop_counts()["Global"]
    assert counts[op] == dx and counts[torch.ops.aten.mm] == fwd


def test_b3_formula_is_its_b1_launch():
    """B3 without a gradient (its operator) counts what its B1 launch on the
    f=4 block grid counts with a gradient; about 5x the 7^3 conv's model
    FLOPs."""
    x = torch.randn(2, 16, 12, 8, 1)
    w = torch.randn(7, 7, 7, 1, 4)
    op_b1, op_b3 = torch.ops.contrast_gan_3d_torch.block_conv3x3x3, torch.ops.contrast_gan_3d_torch.s2d_conv3d_block
    mode = FlopCounterMode(display=False)
    with torch.no_grad(), mode:
        block_conv.s2d_conv3d_block(x, w, None, f=4, padding_mode="reflect")
    b3 = mode.get_flop_counts()["Global"][op_b3]
    assert b3 == block_conv.s2d_conv3d_block_flops(x.shape, w.shape)
    with mode:
        block_conv.s2d_conv3d_block(x, w.requires_grad_(), None, f=4, padding_mode="reflect")
    assert mode.get_flop_counts()["Global"][op_b1] == b3
    model = block_conv.s2d_conv3d_model_flops(x.shape, w.shape)
    assert model == 2 * 2 * 16 * 12 * 8 * 343 * 4 and 4 < b3 / model < 8


# --- the train CLI's fallback to dataset_paths -----------------------------------------------------------------


FALLBACK = '''
from dataclasses import replace


def config(base):
    return replace(base, name="tiny", seed=5, train_patch_size=(16, 16, 16), val_patch_size=(16, 16, 16),
                   train_batch_size={{0: 2, -1: 1, 1: 1}}, val_batch_size={{0: 1, -1: 1, 1: 1}},
                   generator_args={{"n_resnet_blocks": 1, "n_updownsample_blocks": 1, "init_channels_out": 4}},
                   critic_args={{"init_channels_out": 4, "discriminator_depth": 2, "negative_slope": 0.2}},
                   compute_dtype="float32", augment_backend="device", num_workers=(1, 1), log_every=2,
                   validate_every=None, checkpoint_every=None, logger="console", dataset_paths={paths!r})
'''


def test_train_cli_builds_one_fold_from_dataset_paths(tmp_path):
    rng = np.random.default_rng(2)
    rows = []
    for i, label in enumerate([0, -1, 1] * 4):
        vol = rng.integers(-200, 600, (20, 20, 20)).astype(np.int16)
        mask = np.zeros((20, 20, 20), np.uint8)
        mask[5:15, 10, 10] = 1
        meta = {"spacing": np.ones(3), "offset": np.zeros(3), "ostia_world": np.zeros((2, 3), np.float32),
                "centerlines_world": np.zeros((0, 4), np.float32)}
        path = jax_pre.write_patient(vol, mask, meta, f"p{i}", tmp_path / "data")
        rows.append({"ID": f"p{i}", "path": str(path), "mu": 0.0, "std": 1.0, "label": label})
    sheet = lab.write_sheet(rows, tmp_path / "dataset.csv")
    conf = tmp_path / "tiny.py"
    conf.write_text(FALLBACK.format(paths=(str(sheet),)))
    args = ["--conf", str(conf), "--checkpoint-root", str(tmp_path / "runs"), "--run-id", "r", "--device", "cpu"]
    manager = train_cli.main([*args, "--iterations", "2"])
    want_train, want_val = jax_lab.cross_val_splits(1, sheet, seed=5)
    norm = lambda folds: [[(str(p), int(lbl)) for p, lbl in fold] for fold in folds]
    assert manager.train_folds == norm(want_train) and manager.val_folds == norm(want_val)
    assert manager.runs[0].trainer.iteration == 2
    conf.write_text(FALLBACK.format(paths=()))
    with pytest.raises(SystemExit, match="dataset_paths"):
        train_cli.main(args)
    # data-parallel ranks split the sheets each: unseeded, they would differ
    conf.write_text(FALLBACK.format(paths=(str(sheet),)).replace("seed=5, ", ""))
    with pytest.raises(SystemExit, match="seed"):
        train_cli.main([*args, "--dp-devices", "2"])
