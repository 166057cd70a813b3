"""The learning check's pieces in the port against the JAX package, on the
CPU: the sliding window's resize branch (a patch size the generator does
not divide), the f32 scope the entry points run in (``full_f32``), the
HU-distribution-shift evaluation and its command, and
``validate_learning``'s summary and eval lists.

Tolerances: the resize branch in f32 within 0.1 HU of JAX (1e-4 tanh
units x 600 HU, the corrector tests' bound), in bf16 by the bf16 rule of
``tests/test_torch_port_bf16.py``; the HU-shift summaries exactly."""

import json
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from contrast_gan_3d_tpu.alias import ScanType as JaxScanType
from contrast_gan_3d_tpu.eval import hu_distribution_shift as jax_hu
from contrast_gan_3d_tpu.eval.corrector import CCTAContrastCorrector as JaxCorrector
from contrast_gan_3d_tpu.models.generator import ResnetGenerator as JaxGenerator
from contrast_gan_3d_tpu.utils import io_utils as jax_io
from contrast_gan_3d_tpu_torch import eval_hu_shift, validate_learning
from contrast_gan_3d_tpu_torch.eval import hu_distribution_shift as port_hu
from contrast_gan_3d_tpu_torch.eval.corrector import CCTAContrastCorrector
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.serving import CorrectionService
from contrast_gan_3d_tpu_torch.utils.device import full_f32, tf32_flags
from contrast_gan_3d_tpu_torch.utils.weights import generator_state_dict_from_jax
from tests.test_torch_port_bf16 import assert_bf16_rule, carried, jax_runs
from tests.test_torch_port_models import carried_generator

REPO = Path(__file__).resolve().parents[1]
JAX_RECORD = REPO / "reports" / "synthetic_study" / "validate_learning.json"
# n_updownsample_blocks=2 (the default): a generator that divides by 4, so
# an 18^3 patch comes back ceil-rounded as 20^3
GEN = dict(n_resnet_blocks=1, init_channels_out=4)
PATCH = (18, 18, 18)


# --- the resize branch ----------------------------------------------------------


def test_resize_branch_matches_jax_f32():
    """A (30, 26, 22) int16 volume in 18^3 patches at 50% overlap, batch 3
    (8 patches: a remainder batch), default layout: both packages resolve
    the direct window, the generator returns 20^3, resized back; within
    0.1 HU of JAX."""
    jgen, variables, tgen = carried_generator(GEN, 21, shape=(1, *PATCH, 1))
    vol = np.random.default_rng(22).integers(-1024, 1500, (30, 26, 22)).astype(np.int16)
    kw = dict(inference_patch_size=PATCH, overlap=0.5, batch_size=3)
    jcorr = JaxCorrector(jgen, variables["params"], variables["batch_stats"], **kw)
    corr = CCTAContrastCorrector(tgen, device="cpu", **kw)
    assert not corr.packed and not jcorr._packed
    with torch.no_grad():
        assert tuple(tgen(torch.zeros(1, 1, *PATCH)).shape[2:]) == (20, 20, 20)
    got = corr(vol)
    assert got.dtype == torch.float32 and tuple(got.shape) == vol.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(jcorr(vol)), rtol=0, atol=0.1)


def test_resize_branch_matches_jax_bf16():
    """The same window with a bf16 generator behind ``dtype=bfloat16``
    correctors (JAX resizes the bf16 attenuation before its f32 cast; so
    does the port), by the bf16 rule against JAX's f32 and bf16 runs."""
    variables, make, gen = carried(JaxGenerator, ResnetGenerator, GEN, (1, *PATCH, 1),
                                   generator_state_dict_from_jax, 23)
    vol = np.random.default_rng(24).integers(-1024, 1500, (30, 26, 22)).astype(np.int16)
    kw = dict(inference_patch_size=PATCH, overlap=0.5, batch_size=3)

    def run(dtype, jit, _):
        corrector = JaxCorrector(make(dtype), variables["params"], variables["batch_stats"], dtype=dtype, **kw)
        return jit(corrector.correct_volume)(vol)

    j32, j16s = jax_runs(run)
    got = CCTAContrastCorrector(gen, device="cpu", dtype=torch.bfloat16, **kw)(vol)
    assert got.dtype == torch.float32 and tuple(got.shape) == vol.shape
    assert_bf16_rule(got, j16s, j32, "corrected HU (resize branch)")


# --- the f32 scope (C6) ---------------------------------------------------------


@pytest.fixture
def restore_flags():
    saved = (tf32_flags(), torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    yield
    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32), \
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


@pytest.mark.parametrize("start", [(True, False), (True, True), (False, False)])
def test_full_f32_restores_the_callers_flags(restore_flags, start):
    """Inside: both TF32 switches off, nested scopes too; the caller's
    ``deterministic`` and ``benchmark`` untouched; on exit (also by an
    exception) the switches as the caller left them."""
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = start
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, True
    with full_f32():
        assert tf32_flags() == (False, False)
        with full_f32():
            assert tf32_flags() == (False, False)
        assert tf32_flags() == (False, False)
        assert torch.backends.cudnn.deterministic and torch.backends.cudnn.benchmark
    assert tf32_flags() == start
    with pytest.raises(KeyError), full_f32():
        raise KeyError("x")
    assert tf32_flags() == start
    assert torch.backends.cudnn.deterministic and torch.backends.cudnn.benchmark


def test_full_f32_is_thread_safe(restore_flags):
    """Threads entering and leaving overlapping scopes (a daemon's handlers):
    every thread sees the switches off inside its scope, and they are
    back on after the last one leaves."""
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, True
    seen, switch = [], sys.getswitchinterval()

    def worker():
        for _ in range(300):
            with full_f32():
                seen.append(tf32_flags())

    threads = [threading.Thread(target=worker) for _ in range(8)]
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert len(seen) == 2400 and set(seen) == {(False, False)}
    assert tf32_flags() == (True, True)


class _FlagProbe(torch.nn.Module):
    """A generator stand-in that records the TF32 switches it runs under."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def forward(self, x):
        self.seen.append(tf32_flags())
        return torch.zeros_like(x)


def test_entry_points_run_in_full_f32(restore_flags):
    """With PyTorch's default switches set (cuDNN TF32 on), the corrector
    and the daemon's service run their generator with both switches off,
    and leave the process's switches as they were."""
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    probe = _FlagProbe()
    corr = CCTAContrastCorrector(probe, inference_patch_size=(8, 8, 8), device="cpu")
    vol = np.zeros((8, 8, 8), np.int16)
    corr(vol)
    CorrectionService(corr).correct(vol)
    assert len(probe.seen) == 2 and set(probe.seen) == {(False, False)}
    assert tf32_flags() == (True, False)


def test_train_cli_fits_in_full_f32(restore_flags, tmp_path, monkeypatch):
    """The train CLI runs ``Trainer.fit`` (and so every cycle's CUDA-graph
    capture) with both switches off, and restores them after."""
    import pickle

    from contrast_gan_3d_tpu_torch import train
    from contrast_gan_3d_tpu_torch.data.preprocess import write_patient

    rng = np.random.default_rng(41)
    fold = []
    for label in (0, -1, 1):
        vol, mask, meta = validate_learning.synth_patient(rng, (20, 20, 20), validate_learning.VESSEL_HU[label])
        fold.append((str(write_patient(vol, mask, meta, f"p{label}", tmp_path / "data")), label))
    with open(tmp_path / "splits.pkl", "wb") as fd:
        pickle.dump({"train": [fold], "test": [fold]}, fd)
    (tmp_path / "conf.py").write_text(
        "from dataclasses import replace\n"
        "def config(base):\n"
        "    return replace(base, train_patch_size=(16, 16, 16), train_batch_size={0: 2, -1: 1, 1: 1},\n"
        "                   generator_args=dict(n_resnet_blocks=1, n_updownsample_blocks=1, init_channels_out=4),\n"
        "                   critic_args=dict(init_channels_out=4, discriminator_depth=2), validate_every=None,\n"
        "                   num_workers=(1, 1))\n")
    seen = []
    monkeypatch.setattr(train.Trainer, "fit", lambda self, *a, **k: seen.append(tf32_flags()))
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, True
    train.main(["--conf", str(tmp_path / "conf.py"), "--cval-splits", str(tmp_path / "splits.pkl"),
                "--checkpoint-root", str(tmp_path / "runs"), "--iterations", "1", "--logger", "none",
                "--device", "cpu"])
    assert seen == [(False, False)] and tf32_flags() == (True, True)


# --- the HU-shift evaluation ----------------------------------------------------


def _eval_cohort(root: Path):
    """Two LOW and one OPT synthetic raw scans (validate_learning's writer)
    and a myocardium segmentation for the first; the eval list as
    eval_hu_shift reads it."""
    rng = np.random.default_rng(31)
    root.mkdir(parents=True, exist_ok=True)
    entries = []
    for name, hu, label in (("low_0", 250, -1), ("low_1", 260, -1), ("opt_0", 400, 0)):
        vol, _, scan, pdir = validate_learning.write_raw(rng, (20, 18, 16), root, name, hu)
        myo = None
        if name == "low_0":
            myo = root / "low_0_myo.mhd"
            jax_io.write_mhd((vol > 100).astype(np.int16), myo)
            myo = str(myo)
        entries.append([[str(scan), str(pdir), myo], label])
    entries.append([[str(root / "missing.mhd"), str(root / "low_0"), None], -1])  # skipped by both
    (root / "list.json").write_text(json.dumps(entries))
    return root / "list.json"


def test_hu_shift_matches_jax(tmp_path):
    """``collect_voxels_intensity`` (centerlines, ostia, a myocardium mask,
    a missing scan skipped) and ``summarize_hu_shift``: JAX's voxels and
    summaries exactly."""
    lst = _eval_cohort(tmp_path)
    got = port_hu.collect_voxels_intensity(eval_hu_shift.load_eval_list(lst), workers=2)
    want = jax_hu.collect_voxels_intensity(eval_hu_shift.load_eval_list(lst), workers=2)
    assert {st.name: sorted(d) for st, d in got.items()} == {st.name: sorted(d) for st, d in want.items()}
    for st, d in want.items():
        for region, vals in d.items():
            g = got[type(next(iter(got)))[st.name]][region]
            assert g.dtype == vals.dtype and np.array_equal(g, vals), (st, region)
    assert set(want[JaxScanType.LOW]) == {"centerlines", "ostia", "myocardium"}
    assert port_hu.summarize_hu_shift(got) == jax_hu.summarize_hu_shift(want)


def test_eval_hu_shift_cli_writes_jax_summaries(tmp_path):
    """Two series: ``hu_shift_<tag>.json`` each, equal to JAX's summary of
    the same list, and the comparison figure JAX's script names
    ``hu_shift_compare.png`` (no figure until the figures were ported; its
    pixels against JAX's: ``tests/test_torch_port_logger.py``)."""
    lst = _eval_cohort(tmp_path / "raw")
    out = tmp_path / "out"
    summaries = eval_hu_shift.main([str(lst), str(out), "--workers", "1", "--series", f"again={lst}"])
    want = jax_hu.summarize_hu_shift(jax_hu.collect_voxels_intensity(eval_hu_shift.load_eval_list(lst), 1))
    for tag in ("original", "again"):
        assert json.loads((out / f"hu_shift_{tag}.json").read_text()) == want == summaries[tag]
    assert [p.name for p in out.glob("*.png")] == ["hu_shift_compare.png"]
    with pytest.raises(SystemExit):
        eval_hu_shift.main([str(lst), str(out), "--series", "no-equals-sign"])


# --- validate_learning ----------------------------------------------------------


def test_validate_learning_writes_the_jax_scripts_keys_and_lists(tmp_path):
    """6 iterations on the CPU in 5-iteration cycles with an eval cohort of
    2: the JAX record's keys (its cohort, made from the same seed, gives
    the same held-out scans: LOW 249.8 and HIGH 550.0 HU before), the
    lists in eval_hu_shift's format naming files that exist, and the
    summary written to ``--out``."""
    wd = tmp_path / "study"
    summary = validate_learning.main(["--iterations", "6", "--cycle-length", "5", "--workdir", str(wd),
                                      "--eval-cohort", "2", "--out", str(wd / "summary.json"), "--device", "cpu"])
    record = json.loads(JAX_RECORD.read_text())
    assert set(summary) == set(record)
    assert json.loads((wd / "summary.json").read_text()) == summary
    for key in ("target_corridor", "mode", "family", "p_centerline_3d", "data_format",
                "centerline_mean_hu_before", "high_centerline_mean_hu_before"):
        assert summary[key] == record[key], key
    assert (wd / "ckpt" / "6.pt").exists()
    original = json.loads((wd / "original_list.json").read_text())
    corrected = json.loads((wd / "corrected_list.json").read_text())
    assert [label for _, label in original] == [-1, -1, 0, 0] and [label for _, label in corrected] == [-1, -1]
    for paths, _ in original + corrected:
        assert Path(paths[0]).exists() and (Path(paths[1]) / "ostia.xml").exists() and paths[2] is None
    assert summary["eval_lists"] == {"original": str(wd / "original_list.json"),
                                     "corrected": str(wd / "corrected_list.json")}


def test_validate_learning_usage_errors():
    # --data-format h5 was a usage error until HDF5 was ported
    # (tests/test_torch_port_hdf5.py runs it); an unknown format is one
    for argv in (["--data-format", "zarr"], ["--family", "2d", "--gp"]):
        with pytest.raises(SystemExit) as e:
            validate_learning.main([*argv, "--device", "cpu"])
        assert e.value.code == 2
