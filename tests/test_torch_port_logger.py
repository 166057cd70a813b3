"""The port's experiment loggers, builder wiring, trainer image hand-over,
``view_batches`` and ``eval_hu_shift`` figures against the JAX package's,
on the CPU with tiny inputs made from a seed.

Figures render with one matplotlib, Agg and the same rcParams in this
process, so the PNGs either logger writes are compared pixel for pixel
(decoded, not as bytes); scalar files line for line; TensorBoard event
files read back with tensorboard's ``EventFileLoader``; wandb through a
stub module, the figures handed to ``wandb.Image`` rendered to pixels at
that moment. The tiny fits (f32, weight clip, no augmentation, JAX's
weights on both sides; ``tests/test_torch_port_fit.py``'s sizes) hand
the loggers the same arrays: the scaled sample and the mask exactly, the
reconstruction and the attenuation within 1e-3 of the largest JAX value
(the fit tests' loss tolerance: the images render after a step whose
parameters agree within 2 lr per update).
"""

import dataclasses
import io
import json
import pickle
import subprocess
import sys
import threading
import time
import types
from functools import partial
from pathlib import Path

import jax
import numpy as np
import pytest
from matplotlib import image as mpl_image

from contrast_gan_3d_tpu.data import pipeline as jax_pipeline
from contrast_gan_3d_tpu.data.scaler import FactorZeroCenterScaler as JaxScaler
from contrast_gan_3d_tpu.experiments import builder as jax_builder
from contrast_gan_3d_tpu.experiments import config as jax_config
from contrast_gan_3d_tpu.trainer import logger as jax_logger
from contrast_gan_3d_tpu.trainer import trainer as jax_trainer
from contrast_gan_3d_tpu_torch import eval_hu_shift, view_batches
from contrast_gan_3d_tpu_torch.data.pipeline import create_loaders
from contrast_gan_3d_tpu_torch.data.scaler import FactorZeroCenterScaler
from contrast_gan_3d_tpu_torch.experiments import builder, config
from contrast_gan_3d_tpu_torch.trainer import logger as port_logger
from contrast_gan_3d_tpu_torch.trainer.trainer import Trainer, TrainerConfig
from tests.synth import make_dataset
from tests.test_scripts_cli import _load_script
from tests.test_torch_port_learning import _eval_cohort
from tests.test_torch_port_train import Pair

REPO = Path(__file__).resolve().parents[1]
PATCH = (16, 16, 16)
BATCH = {0: 2, -1: 1, 1: 1}


def _png(path):
    return mpl_image.imread(str(path))


def _assert_same_pngs(got_dir: Path, want_dir: Path):
    got, want = sorted(p.name for p in got_dir.glob("*.png")), sorted(p.name for p in want_dir.glob("*.png"))
    assert got == want and got
    for name in got:
        np.testing.assert_array_equal(_png(got_dir / name), _png(want_dir / name), err_msg=name)


def _batch3d(seed=0, b=2):
    rng = np.random.default_rng(seed)
    sample = rng.normal(0, 0.3, (b, 8, 8, 6)).astype(np.float32)
    mask = (rng.random((b, 8, 8, 6)) < 0.05).astype(np.float32)
    return sample, mask


SCALARS = [({"D": -0.5, "G": np.float32(1.25)}, 10, "train"), ({"D": float("nan"), "sim": 0.5}, 11, "train"),
           ({"G": float("inf")}, 20, "validation")]


# --- the file logger -------------------------------------------------------------


@pytest.mark.parametrize("family", ["3d", "2d", "2d_one"])
def test_file_logger_pngs_and_scalars_equal_jax(tmp_path, family):
    """PNG grids pixel-equal from the same scaler, arrays and rng seed (two
    events, so the rng must advance as JAX's); scalars.jsonl line-equal."""
    port_cls, jax_cls = ((port_logger.FileLogger, jax_logger.FileLogger) if family == "3d"
                         else (port_logger.FileLogger2D, jax_logger.FileLogger2D))
    ours = port_cls(FactorZeroCenterScaler(), tmp_path / "port", max_slices=4, rng=np.random.default_rng(4))
    theirs = jax_cls(JaxScaler(), tmp_path / "jax", max_slices=4, rng=np.random.default_rng(4))
    assert ours.logs_images and theirs.logs_images
    if family == "3d":
        sample, mask = _batch3d()
        events = [(sample, sample * 0.5, sample - 0.1, mask, ["a", "b"], 42, "train"),
                  (sample, None, sample, mask, ["a"], 43, "validation")]  # names shorter than the batch
    elif family == "2d":
        batch = np.random.default_rng(1).normal(0, 0.3, (5, 8, 8)).astype(np.float32)
        events = [(batch, batch * 0.9, None, None, None, 7, "validation"),
                  (batch[..., None], batch[..., None], batch[..., None], None, None, 8, "train")]
    else:  # a batch of one keeps its orientation (W != H)
        one = np.random.default_rng(2).normal(size=(1, 8, 12, 1)).astype(np.float32)
        events = [(one, one, one, None, None, 1, "train")]
    for lg in (ours, theirs):
        for ev in events:
            lg.log_images(*ev)
        for scalars, step, stage in SCALARS:
            lg.log_scalars(scalars, step, stage)
    _assert_same_pngs(tmp_path / "port" / "images", tmp_path / "jax" / "images")
    assert ours.rng.bit_generator.state == theirs.rng.bit_generator.state
    assert (tmp_path / "port" / "scalars.jsonl").read_text() == (tmp_path / "jax" / "scalars.jsonl").read_text()
    # save_images=False turns the trainer's gate off, as in JAX
    off = port_logger.FileLogger(FactorZeroCenterScaler(), tmp_path / "off", save_images=False)
    assert off.logs_images is False and port_logger.MultiThreadedLogger(off).logs_images is False
    off.log_images(*events[0])
    assert not (tmp_path / "off" / "images").exists()


# --- TensorBoard -----------------------------------------------------------------


def _tb_events(out: Path):
    """{(tag, step): value or decoded image pixels} over every event file.
    tensorboardX writes tensor protos: a scalar, or an image's (width,
    height, PNG bytes)."""
    from tensorboard.backend.event_processing.event_file_loader import EventFileLoader
    from tensorboard.util import tensor_util

    found = {}
    for f in sorted(out.glob("events.out.tfevents.*")):
        for ev in EventFileLoader(str(f)).Load():
            for v in getattr(ev.summary, "value", []):
                value = tensor_util.make_ndarray(v.tensor)
                if v.metadata.plugin_data.plugin_name == "images":
                    value = mpl_image.imread(io.BytesIO(value[2]), format="png")
                found[v.tag, ev.step] = value
    return found


@pytest.mark.parametrize("family", ["3d", "2d"])
def test_tensorboard_event_files_equal_jax(tmp_path, monkeypatch, family):
    """Scalars equal, images decode to equal pixels; a resumed writer in the
    same directory appends a second file. (tensorboard reads without
    TensorFlow, which it would otherwise import: 10 s.)"""
    monkeypatch.setitem(sys.modules, "tensorboard.compat.notf", types.ModuleType("tensorboard.compat.notf"))
    port_cls, jax_cls = ((port_logger.TensorBoardLogger, jax_logger.TensorBoardLogger) if family == "3d"
                         else (port_logger.TensorBoardLogger2D, jax_logger.TensorBoardLogger2D))
    sample, mask = _batch3d(3)
    args = (sample, sample, sample, mask, ["a", "b"]) if family == "3d" else (sample[:, :, :, 0], None, None, None,
                                                                              None)
    for cls, scaler, out in ((port_cls, FactorZeroCenterScaler(), tmp_path / "port"),
                             (jax_cls, JaxScaler(), tmp_path / "jax")):
        lg = cls(scaler, out, max_slices=4, rng=np.random.default_rng(6))
        for scalars, step, stage in SCALARS[:1] + SCALARS[2:]:
            lg.log_scalars(scalars, step, stage)
        lg.log_images(*args, 42, "train")
        lg.end_hook()
        resumed = cls(scaler, out, max_slices=4)
        resumed.log_scalars({"D": 2.0}, 50)
        resumed.end_hook()
    got, want = _tb_events(tmp_path / "port"), _tb_events(tmp_path / "jax")
    assert set(got) == set(want) and ("train/D", 50) in got and ("train/sample", 42) in got
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=str(key))
    assert len(list((tmp_path / "port").glob("events.out.tfevents.*"))) == 2


# --- wandb, through a stub --------------------------------------------------------


class FakeRun:
    def __init__(self):
        self.logged, self.metrics = [], []

    def define_metric(self, *a, **k):
        self.metrics.append((a, k))

    def log(self, payload):
        self.logged.append(payload)


def _stub_wandb(run):
    """A wandb module whose Image renders the figure to pixels at once (the
    logger closes it after)."""
    from tests.test_torch_port_visualization import _pixels

    return types.SimpleNamespace(run=run, Image=_pixels, __name__="wandb")


@pytest.mark.parametrize("family", ["3d", "2d"])
def test_wandb_payloads_equal_jax(monkeypatch, caplog, family):
    ours_run, theirs_run = FakeRun(), FakeRun()
    monkeypatch.setitem(sys.modules, "wandb", _stub_wandb(ours_run))
    monkeypatch.setattr(jax_logger, "wandb", _stub_wandb(theirs_run))
    monkeypatch.setattr(jax_logger, "HAS_WANDB", True)
    assert port_logger.has_wandb()
    port_cls, jax_cls = ((port_logger.WandbLogger, jax_logger.WandbLogger) if family == "3d"
                         else (port_logger.WandbLogger2D, jax_logger.WandbLogger2D))
    sample, mask = _batch3d(5)
    args = (sample, sample, sample, mask, ["a", "b"]) if family == "3d" else (sample[..., 0], sample[..., 1], None,
                                                                              None, None)
    for cls, scaler in ((port_cls, FactorZeroCenterScaler()), (jax_cls, JaxScaler())):
        lg = cls(scaler, max_slices=4, rng=np.random.default_rng(8))
        for scalars, step, stage in SCALARS[:1]:
            lg.log_scalars(scalars, step, stage)
        lg.log_images(*args, 12, "validation")
    assert ours_run.metrics == theirs_run.metrics == [(("iteration",), {}), (("*",), {"step_metric": "iteration"})]
    assert len(ours_run.logged) == len(theirs_run.logged) == 2
    for got, want in zip(ours_run.logged, theirs_run.logged):
        assert list(got) == list(want) and got["iteration"] == want["iteration"]
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # no active run: dropped, one warning; an explicit run wins
    sys.modules["wandb"].run = None
    lg = port_cls(FactorZeroCenterScaler())
    with caplog.at_level("WARNING", logger=port_logger.__name__):
        lg.log_scalars({"D": 1.0}, 1)
        lg.log_images(*args, 2)
    assert sum("no active run" in r.message for r in caplog.records) == 1
    mine = FakeRun()
    port_cls(FactorZeroCenterScaler(), run=mine).log_scalars({"D": 3.0}, 5)
    assert mine.logged == [{"train/D": 3.0, "iteration": 5}] and len(mine.metrics) == 2


def test_wandb_absent_raises_as_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)
    assert not port_logger.has_wandb()
    with pytest.raises(ImportError, match="wandb"):
        port_logger.WandbLogger(FactorZeroCenterScaler())


# --- the threaded logger ------------------------------------------------------------


def test_multithreaded_logger_renders_one_at_a_time_and_joins(tmp_path):
    state = {"now": 0, "max": 0, "done": []}
    lock = threading.Lock()

    class Slow(port_logger.LoggerInterface):
        def log_scalars(self, scalars, step, stage="train"):
            state["done"].append(("scalars", step))

        def log_images(self, sample, reconstruction, attenuation, masks, names, step, stage="train"):
            with lock:
                state["now"] += 1
                state["max"] = max(state["max"], state["now"])
            time.sleep(0.05)
            with lock:
                state["now"] -= 1
            state["done"].append((stage, step, type(sample).__name__, names))

    lg = port_logger.MultiThreadedLogger(Slow())
    assert lg.logs_images
    sample, mask = _batch3d()
    for step in range(4):
        lg.log_images(sample, None, None, mask, ["a"], step, "train")
        lg.log_images(list(sample), None, None, None, None, step, "validation")
    lg.log_scalars({"D": 1.0}, 3)
    threads = list(lg._threads)
    assert len(threads) <= 8 and all(t.name.startswith("log-images-") for t in threads)
    lg.end_hook()
    assert not any(t.is_alive() for t in threads) and lg._threads == []
    assert state["max"] == 1 and len(state["done"]) == 9
    assert ("train", 3, "ndarray", ["a"]) in state["done"] and ("validation", 3, "list", None) in state["done"]
    # the file logger behind it writes its PNGs by end_hook
    flg = port_logger.MultiThreadedLogger(port_logger.FileLogger(FactorZeroCenterScaler(), tmp_path, max_slices=2))
    flg.log_images(sample[:1], None, None, None, None, 1)
    flg.end_hook()
    assert (tmp_path / "images" / "train_sample_00000001.png").exists()


# --- the builder --------------------------------------------------------------------


def _described(lg, root: Path):
    inner = lg.inner if isinstance(lg, (port_logger.MultiThreadedLogger, jax_logger.MultiThreadedLogger)) else None
    out = {"outer": type(lg).__name__, "inner": type(inner).__name__ if inner else None, "images": lg.logs_images}
    if inner is not None:
        out["rng"] = inner.rng.bit_generator.state
        out["max_slices"] = inner.max_slices
        if hasattr(inner, "out_dir"):
            out["dir"] = inner.out_dir.relative_to(root).as_posix()
    return out


@pytest.mark.parametrize("name", ["basic_3d", "conf_2d"])
def test_builder_wires_every_logger_as_jax(tmp_path, monkeypatch, name):
    stub = _stub_wandb(FakeRun())
    monkeypatch.setattr(jax_logger, "wandb", stub)
    monkeypatch.setattr(jax_logger, "HAS_WANDB", True)
    monkeypatch.setattr(jax_builder, "HAS_WANDB", True)
    monkeypatch.setitem(sys.modules, "wandb", stub)
    for kind in ("wandb", "tensorboard", "file", "console", "none"):
        ours = builder.build(dataclasses.replace(config.PRESETS[name](), logger=kind),
                             checkpoint_dir=str(tmp_path / "port" / kind), device="cpu").logger_interface
        theirs = jax_builder.build(dataclasses.replace(jax_config.PRESETS[name](), logger=kind),
                                   checkpoint_dir=str(tmp_path / "jax" / kind)).logger_interface
        assert _described(ours, tmp_path / "port" / kind) == _described(theirs, tmp_path / "jax" / kind), kind
        ours.end_hook()
        theirs.end_hook()
    for b, c, kw in ((builder, config, dict(device="cpu")), (jax_builder, jax_config, {})):
        with pytest.raises(ValueError, match="unknown logger"):
            b.build(dataclasses.replace(c.PRESETS[name](), logger="files"), **kw)


def test_builder_wandb_absent_is_console(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)
    built = builder.build(dataclasses.replace(config.basic_3d(), logger="wandb"), device="cpu")
    assert isinstance(built.logger_interface, port_logger.ConsoleLogger)


NO_MATPLOTLIB = r'''
import logging, sys, types
sys.modules["matplotlib"] = None
logging.basicConfig(level=logging.WARNING, format="%(levelname)s %(message)s")
from contrast_gan_3d_tpu_torch.data.scaler import FactorZeroCenterScaler
from contrast_gan_3d_tpu_torch.trainer import logger as L
from contrast_gan_3d_tpu_torch.utils import visualization as viz
out = sys.argv[1]
lg = L.MultiThreadedLogger(L.FileLogger(FactorZeroCenterScaler(), out + "/metrics"))
print("file", lg.logs_images)
lg.log_scalars({"D": 1.5}, 3)
lg.end_hook()
print("scalars", open(out + "/metrics/scalars.jsonl").read().strip())
sys.modules["wandb"] = types.SimpleNamespace(run=None, Image=None)
print("wandb", L.WandbLogger(FactorZeroCenterScaler()).logs_images)
print("tb", L.TensorBoardLogger(FactorZeroCenterScaler(), out + "/tb").logs_images)
try:
    viz.plot_axial_slices([[0.0]])
except ImportError as e:
    print("plot raises ImportError:", "matplotlib" in str(e))
'''


def test_without_matplotlib_loggers_take_scalars_only(tmp_path):
    """The one deliberate difference from JAX's loggers: without matplotlib
    a logger built to take images warns once, naming it, and takes scalars
    only, so the trainer computes no image batch for it (the builder's
    file logger on the card's machine is ``chip_smoke.py``'s phase 50)."""
    res = subprocess.run([sys.executable, "-c", NO_MATPLOTLIB, str(tmp_path)], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[0] == "file False"
    assert lines[1] == 'scalars {"stage": "train", "iteration": 3, "D": 1.5}'
    assert lines[2:] == ["wandb False", "tb False", "plot raises ImportError: True"]
    warnings = [line for line in res.stderr.splitlines() if line.startswith("WARNING") and "matplotlib" in line]
    assert [w.split(":")[0] for w in warnings] == ["WARNING FileLogger", "WARNING WandbLogger",
                                                   "WARNING TensorBoardLogger"], res.stderr


# --- the trainer's image hand-over ------------------------------------------------------


@pytest.fixture(scope="module")
def fold(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp("patients"), np.random.default_rng(0), n_per_label=2,
                        shape=(20, 20, 20))


def _recording(cls):
    class Recording(cls):
        def log_images(self, *args):
            self.images.append(args)
            super().log_images(*args)

    return Recording


def test_fit_hands_the_logger_jax_arrays_and_writes_its_files(fold, tmp_path):
    """Two combined iterations, images at 0 and 1 and at the validation at
    1: the same arrays as JAX's trainer, and the same PNG and scalar names."""
    pair = Pair("wc", seed=5)
    common = dict(train_iterations=2, train_critic_every=1, train_generator_every=1, val_every=1, val_iterations=1,
                  log_every=1, log_images_every=1, checkpoint_every=None)
    jlog = _recording(jax_logger.FileLogger)(JaxScaler(), tmp_path / "jax", max_slices=1,
                                             rng=np.random.default_rng(0))
    plog = _recording(port_logger.FileLogger)(FactorZeroCenterScaler(), tmp_path / "port", max_slices=1,
                                              rng=np.random.default_rng(0))
    jlog.images, plog.images = [], []
    jloaders = partial(jax_pipeline.create_loaders, fold, PATCH, BATCH, num_threads=1, prefetch=2, to_device=False)
    jt = jax_trainer.Trainer(pair.jgen, pair.jcritic, pair.tx, pair.tx, pair.jcfg,
                             jax_trainer.TrainerConfig(**common, cycle_length=1), jax.random.key(0), PATCH,
                             logger_interface=jlog, state=pair.jstate, auto_resume=False)
    jt.fit(jloaders(rng=np.random.default_rng(13)), jloaders(rng=np.random.default_rng(14)))
    ploaders = partial(create_loaders, fold, PATCH, BATCH, num_threads=1, prefetch=2, to_device=False)
    pt = Trainer(pair.tgen, pair.tcritic, pair.tx_port, pair.tx_port, pair.cfg, TrainerConfig(**common),
                 logger_interface=plog, device="cpu")
    pt.fit(ploaders(rng=np.random.default_rng(13)), ploaders(rng=np.random.default_rng(14)))
    assert [e[5:] for e in plog.images] == [e[5:] for e in jlog.images] == [(0, "train"), (1, "train"),
                                                                             (1, "validation")]
    for got, want in zip(plog.images, jlog.images):
        assert got[4] == want[4]  # names
        assert got[0].dtype == np.float32
        for i in (0, 3):  # the scaled sample, the mask (values: JAX's train mask is the loaders' int16)
            assert got[i].shape == want[i].shape
            np.testing.assert_array_equal(got[i], np.asarray(want[i]))
        for i in (1, 2):  # the reconstruction, the attenuation
            want_i = np.asarray(want[i])
            assert got[i].shape == want_i.shape
            np.testing.assert_allclose(got[i], want_i, rtol=0, atol=1e-3 * np.abs(want_i).max())
    assert got[0].shape == (2, *PATCH)
    pngs = sorted(p.name for p in (tmp_path / "port" / "images").glob("*.png"))
    assert pngs == sorted(p.name for p in (tmp_path / "jax" / "images").glob("*.png")) and len(pngs) == 9
    stages = lambda d: [(r["stage"], r["iteration"]) for r in map(json.loads, (d / "scalars.jsonl").open())]
    assert stages(tmp_path / "port") == stages(tmp_path / "jax")


@pytest.mark.parametrize("named", ["all", "low only"])
def test_2d_images_keep_the_loaders_layout(named):
    """JAX's 2D trainer hands ``(n, W, H)`` arrays, n the names' count
    (the whole batch without names): the port's NCHW ``t[:n, 0]`` on a
    non-square slice is the loaders' batch scaled as JAX scales it, not a
    transpose, and the mask is the loaders' mask."""
    from contrast_gan_3d_tpu_torch.models.discriminator import PatchGANDiscriminator
    from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
    from contrast_gan_3d_tpu_torch.trainer.optim import make_optimizer
    from contrast_gan_3d_tpu_torch.trainer.steps import StepConfig

    class Recording(port_logger.LoggerInterface):
        images = []

        def log_images(self, *args):
            self.images.append(args)

    tx = partial(make_optimizer, "adam", lr=1e-3)
    trainer = Trainer(ResnetGenerator(ndim=2, n_resnet_blocks=1, n_updownsample_blocks=1, init_channels_out=4),
                      PatchGANDiscriminator(ndim=2, init_channels_out=4, discriminator_depth=2), tx, tx,
                      StepConfig(weight_clip=0.01), TrainerConfig(train_iterations=1), logger_interface=Recording(),
                      device="cpu")
    rng = np.random.default_rng(0)
    patches = {st: {"data": rng.integers(-500, 900, (n, 32, 16)).astype(np.int16),
                    "seg": (rng.random((n, 32, 16)) < 0.1).astype(np.int16)} for st, n in ((0, 2), (-1, 2), (1, 1))}
    patches[-1]["name"] = ["l0", "l1"]
    if named == "all":
        patches[1]["name"] = ["h0"]
    _, (subopt, mask, names) = trainer.train_step(patches, 0)
    trainer._log_train_images(subopt, mask, names, 0)
    sample, recon, atten, got_mask, got_names, step, stage = trainer.logger_interface.images[-1]
    n = len(names)
    assert n == (3 if named == "all" else 2) and got_names == names and (step, stage) == (0, "train")
    data = np.concatenate([patches[-1]["data"], patches[1]["data"]])[:n]
    seg = np.concatenate([patches[-1]["seg"], patches[1]["seg"]])[:n]
    np.testing.assert_array_equal(sample, JaxScaler()(data.astype(np.float32)))
    np.testing.assert_array_equal(got_mask, seg)
    assert recon.shape == atten.shape == (n, 32, 16)
    np.testing.assert_allclose(recon, sample - atten, atol=1e-6)


# --- the commands ------------------------------------------------------------------------


def test_train_cli_runs_a_wandb_session_per_fold(fold, tmp_path, monkeypatch):
    """``--logger wandb``: the JAX CLI's session through a stub module: the
    resume lookup (group and starting fold), ``wandb.init`` before the
    builder with the run id, the group and the config with its fold, the
    scalars against ``iteration``, images, and ``wandb.finish``."""
    from contrast_gan_3d_tpu_torch import train as train_cli
    from tests.test_torch_port_fit import OVERRIDE

    calls = []

    def init(**kw):
        calls.append(("init", kw))
        stub.run = FakeRun()
        runs.append(stub.run)

    def finish():
        calls.append(("finish", {}))
        stub.run = None

    runs = []
    looked_up = types.SimpleNamespace(group="g1", config={"fold": 0})
    stub = types.SimpleNamespace(run=None, init=init, finish=finish, Image=lambda fig: "image",
                                 Api=lambda: types.SimpleNamespace(run=lambda path: calls.append(("api", path))
                                                                   or looked_up))
    monkeypatch.setitem(sys.modules, "wandb", stub)
    conf, splits = tmp_path / "tiny.py", tmp_path / "splits.pkl"
    conf.write_text(OVERRIDE)
    splits.write_bytes(pickle.dumps({"train": [fold], "test": [fold]}))
    manager = train_cli.main(["--conf", str(conf), "--cval-splits", str(splits), "--checkpoint-root",
                              str(tmp_path / "runs"), "--run-id", "r", "--iterations", "2", "--device", "cpu",
                              "--logger", "wandb", "--wandb-project", "p", "--wandb-entity", "e"])
    assert isinstance(manager.runs[0].trainer.logger_interface.inner, port_logger.WandbLogger)
    assert [c[0] for c in calls] == ["api", "init", "finish"] and calls[0][1] == "e/p/r"
    kw = calls[1][1]
    assert (kw["id"], kw["resume"], kw["name"], kw["project"], kw["entity"], kw["group"]) == ("r", "allow", "r",
                                                                                              "p", "e", "g1")
    assert kw["config"]["fold"] == 0 and kw["config"]["logger"] == "wandb"
    logged = runs[0].logged
    assert [r["iteration"] for r in logged if "train/D" in r] == [0]  # log_every 2
    assert {"train/sample", "train/reconstruction", "train/attenuation"} <= set(next(r for r in logged
                                                                                 if "train/sample" in r))


def test_view_batches_writes_jax_scripts_pngs(tmp_path, monkeypatch):
    fold = make_dataset(tmp_path / "patients", np.random.default_rng(3), n_per_label=1)
    splits = tmp_path / "splits.pkl"
    splits.write_bytes(pickle.dumps({"train": [fold], "test": [fold]}))
    args = [str(splits), "--patch-size", "8", "8", "8", "--batch-size", "2"]
    written = view_batches.main([args[0], str(tmp_path / "port"), *args[1:]])
    assert sorted(p.name for p in written) == ["batch_HIGH.png", "batch_LOW.png", "batch_OPT.png"]
    monkeypatch.setattr(sys, "argv", ["view_batches.py", args[0], str(tmp_path / "jax"), *args[1:]])
    _load_script("view_batches").main()
    _assert_same_pngs(tmp_path / "port", tmp_path / "jax")
    # --augment runs on the named device (the card by default)
    aug = view_batches.main([args[0], str(tmp_path / "aug"), *args[1:], "--augment", "--device", "cpu"])
    assert len(aug) == 3
    with pytest.raises(RuntimeError, match="non-interactive"):
        view_batches.main([args[0], str(tmp_path / "i"), *args[1:], "--interactive"])


def test_eval_hu_shift_writes_jax_scripts_figure(tmp_path, monkeypatch):
    lst = _eval_cohort(tmp_path / "raw")
    eval_hu_shift.main([str(lst), str(tmp_path / "port"), "--workers", "1", "--tag", "orig"])
    monkeypatch.setattr(sys, "argv", ["eval_hu_shift.py", str(lst), str(tmp_path / "jax"), "--workers", "1",
                                      "--tag", "orig"])
    _load_script("eval_hu_shift").main()
    _assert_same_pngs(tmp_path / "port", tmp_path / "jax")
    assert [p.name for p in (tmp_path / "port").glob("*.png")] == ["hu_shift_orig.png"]
