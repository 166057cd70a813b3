"""The port's training run vs the JAX package, on the CPU: patients on
disk, the sampler and the loaders, checkpoints, ``Trainer.fit`` (logging,
validation, images, resume, graceful stop), the config presets, the
builder and the CLI.

Tiny sizes: 16^3 patches from 24^3 synthetic patients, the generator
``n_resnet_blocks=1, n_updownsample_blocks=1, init_channels_out=4``, the
critic ``init_channels_out=4, discriminator_depth=2``. Tolerances:
- sampler and loader batches: bit-identical to JAX's (same files, same
  seed);
- resume: exactly equal to an uninterrupted run (same device, same ops);
- the port's ``fit`` against the JAX ``fit`` (f32, weight clip, no
  augmentation, weights carried from JAX): every logged loss within 1e-3
  relative (1e-5 absolute near zero), every parameter within 2 lr per
  update of its network (Adam's first steps are about lr * sign(g), and a
  gradient that is float noise may take the other sign), the BatchNorm
  statistics within 1e-4.
"""

import dataclasses
import pickle
import signal
import subprocess
import sys
import threading
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrast_gan_3d_tpu.data import pipeline as jax_pipeline
from contrast_gan_3d_tpu.data import preprocess as jax_preprocess
from contrast_gan_3d_tpu.data.sampler import CCTAPatchSampler as JaxSampler
from contrast_gan_3d_tpu.experiments import builder as jax_builder
from contrast_gan_3d_tpu.experiments import config as jax_config
from contrast_gan_3d_tpu.trainer import trainer as jax_trainer
from contrast_gan_3d_tpu_torch import train as train_cli
from contrast_gan_3d_tpu_torch.data import augment as aug
from contrast_gan_3d_tpu_torch.data.pipeline import PrefetchLoader, create_loaders
from contrast_gan_3d_tpu_torch.data.preprocess import load_patient, write_patient
from contrast_gan_3d_tpu_torch.data.sampler import CCTAPatchSampler
from contrast_gan_3d_tpu_torch.experiments import builder, config
from contrast_gan_3d_tpu_torch.models.discriminator import PatchGANDiscriminator
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.models.utils import count_parameters
from contrast_gan_3d_tpu_torch.trainer import checkpoint as ckpt_lib
from contrast_gan_3d_tpu_torch.trainer.logger import (ConsoleLogger, FileLogger, LoggerInterface,
                                                      MultiThreadedLogger, TensorBoardLogger, has_wandb)
from contrast_gan_3d_tpu_torch.trainer.optim import make_optimizer
from contrast_gan_3d_tpu_torch.trainer.steps import StepConfig
from contrast_gan_3d_tpu_torch.trainer.trainer import Trainer, TrainerConfig, install_preemption_handler
from contrast_gan_3d_tpu_torch.utils.weights import critic_state_dict_from_jax, generator_state_dict_from_jax
from tests.synth import make_dataset, synthetic_patient
from tests.test_torch_port_models import _np_tree
from tests.test_torch_port_train import Pair

PATCH = (16, 16, 16)
GEN = dict(n_resnet_blocks=1, n_updownsample_blocks=1, init_channels_out=4)
CRITIC = dict(init_channels_out=4, discriminator_depth=2)
BATCH = {0: 2, -1: 1, 1: 1}
BUILDABLE = ("basic_3d", "gradient_penalty", "small_patch", "rmsprop", "train_generator_more", "test_conf",
             "gp_layernorm", "conf_2d", "gradient_penalty_2d", "test_conf_2d")
UNPORTED = ()


@pytest.fixture(scope="module")
def fold(tmp_path_factory):
    """Two 24^3 patients per label, written by the JAX package, and one
    LOW patient smaller than a patch (the centre-padding path)."""
    root = tmp_path_factory.mktemp("patients")
    rng = np.random.default_rng(0)
    out = make_dataset(root, rng, n_per_label=2)
    vol, mask, _, meta = synthetic_patient(rng, (12, 20, 10))
    out.append((str(jax_preprocess.write_patient(vol, mask, meta, "small", root)), -1))
    return out


class RecordingLogger(LoggerInterface):
    def __init__(self, logs_images=True):
        self.logs_images = logs_images
        self.scalars, self.images = [], []

    def log_scalars(self, scalars, step, stage="train"):
        self.scalars.append((stage, step, dict(scalars)))

    def log_images(self, *args):
        self.images.append(args)


def tiny_trainer(ckpt_dir=None, iterations=4, log=None, augment=True, seed=0, **cfg_kw):
    """The cadences of the JAX package's ``tests/test_trainer.py``: critic
    every 1, generator every 2, validation every 2, logs every iteration,
    images every 3, a checkpoint every 2."""
    torch.manual_seed(seed)
    tx = partial(make_optimizer, "adam", lr=1e-3)
    cfg = TrainerConfig(**{**dict(train_iterations=iterations, train_critic_every=1, train_generator_every=2,
                                  val_every=2, val_iterations=1, log_every=1, log_images_every=3,
                                  checkpoint_every=2, checkpoint_dir=str(ckpt_dir) if ckpt_dir else None),
                           **cfg_kw})
    step_cfg = StepConfig(augment=aug.AugmentConfig(elastic_grid=4, p_rotation=0.5, p_elastic=0.5) if augment else None)
    return Trainer(ResnetGenerator(**GEN), PatchGANDiscriminator(**CRITIC), tx, tx, step_cfg, cfg, seed=seed,
                   logger_interface=log or RecordingLogger(), device="cpu")


def tiny_loaders(fold, seed=7, **kw):
    return create_loaders(fold, PATCH, BATCH, np.random.default_rng(seed), num_threads=1, prefetch=2,
                          to_device=False, **kw)


# --- patients, sampler, loaders ----------------------------------------------


def test_patients_round_trip_like_jax(tmp_path, rng):
    vol, mask, _, meta = synthetic_patient(rng, (10, 12, 8))
    jp = jax_preprocess.write_patient(vol, mask, meta, "p", tmp_path / "jax")
    tp = write_patient(vol, mask, meta, "p", tmp_path / "port")
    (jd, jm), (td, tm) = jax_preprocess.load_patient(jp), load_patient(tp)
    np.testing.assert_array_equal(np.asarray(td), np.asarray(jd))
    assert Path(tp).read_bytes() == Path(jp).read_bytes()
    assert set(tm) == set(jm) and tm["name"] == "p"
    np.testing.assert_array_equal(tm["centerlines_world"], jm["centerlines_world"])
    # HDF5 patients raised until HDF5 was ported: a standalone file and a
    # corpus member the JAX package wrote load as its own loader loads them
    for out in (tmp_path / "h5", tmp_path / "corpus.h5"):
        jh = jax_preprocess.write_patient(vol, mask, meta, "p", out, fmt="h5")
        (jd, jm), (td, tm) = jax_preprocess.load_patient(jh), load_patient(jh)
        np.testing.assert_array_equal(np.asarray(td), np.asarray(jd))
        assert set(tm) == set(jm) and tm["name"] == "p"


@pytest.mark.parametrize("p_centerline_3d", [0.0, 0.6])
@pytest.mark.parametrize("infinite", [True, False])
def test_sampler_batches_bit_identical_to_jax(fold, p_centerline_3d, infinite):
    paths = [p for p, _ in fold]
    kw = dict(p_centerline_3d=p_centerline_3d, infinite=infinite, shuffle=infinite)
    js = JaxSampler(paths, PATCH, 3, rng=np.random.default_rng(11), **kw)
    ps = CCTAPatchSampler(paths, PATCH, 3, rng=np.random.default_rng(11), **kw)
    n = 0
    for jb, pb in zip(js, ps):
        for k in ("data", "seg"):
            assert pb[k].dtype == np.int16
            np.testing.assert_array_equal(pb[k], jb[k])
        assert pb["name"] == jb["name"] and pb["path"] == jb["path"]
        n += 1
        if n == 6:
            break
    assert n == (6 if infinite else 3)  # 7 patients in batches of 3: 3, 3, 1
    assert ps.get_state()["rng"] == js.get_state()["rng"] and ps.get_state()["order"] == js.get_state()["order"]


def test_loader_batches_bit_identical_to_jax(fold):
    jl = jax_pipeline.create_loaders(fold, PATCH, BATCH, np.random.default_rng(3), num_threads=1, prefetch=2,
                                     to_device=False)
    pl = create_loaders(fold, PATCH, BATCH, np.random.default_rng(3), num_threads=1, prefetch=2, to_device=False)
    assert set(pl) == set(jl) == {0, -1, 1}
    try:
        for _ in range(3):
            for label in (0, -1, 1):
                jb, pb = next(jl[label]), next(pl[label])
                np.testing.assert_array_equal(pb["data"], jb["data"])
                np.testing.assert_array_equal(pb["seg"], jb["seg"])
        for label in pl:
            assert pl[label].get_state()["rng"] == jl[label].get_state()["rng"]
    finally:
        for ls in (jl, pl):
            for loader in ls.values():
                loader.stop()


def test_loader_replays_exactly_across_the_queue(fold):
    """``get_state`` is the consumer's position: batches prefetched but not
    served are produced again after a restore."""
    paths = [p for p, _ in fold]

    def mk():
        return PrefetchLoader(CCTAPatchSampler(paths, PATCH, 2, rng=np.random.default_rng(7)), num_threads=1,
                              prefetch=3, to_device=False)

    loader = mk()
    for _ in range(2):
        next(loader)
    state = loader.get_state()
    expected = [next(loader)["data"].copy() for _ in range(4)]
    loader.stop()
    resumed = mk()
    resumed.set_state(state)
    got = [next(resumed)["data"].copy() for _ in range(4)]
    resumed.stop()
    for e, g in zip(expected, got):
        np.testing.assert_array_equal(e, g)
    # a stop()/start() cycle neither skips nor repeats a batch
    loader = mk()
    first = next(loader)["data"].copy()
    loader.stop()
    loader.start()
    second = next(loader)["data"].copy()
    loader.stop()
    straight = mk()
    want = [next(straight)["data"].copy() for _ in range(2)]
    straight.stop()
    np.testing.assert_array_equal(first, want[0])
    np.testing.assert_array_equal(second, want[1])


def test_worker_failure_surfaces_without_a_hang(fold):
    sampler = CCTAPatchSampler([fold[0][0]], (8, 8, 8), 2, rng=np.random.default_rng(0))
    served_first = threading.Event()
    real, calls = sampler.next_batch, {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] >= 2:
            assert served_first.wait(timeout=30)
            raise ValueError("corrupt patient file")
        return real()

    sampler.next_batch = flaky
    loader = PrefetchLoader(sampler, num_threads=1, prefetch=1, to_device=False)
    next(loader)
    served_first.set()
    with pytest.raises(RuntimeError, match="prefetch worker failed") as info:
        for _ in range(5):
            next(loader)
    assert isinstance(info.value.__cause__, ValueError)
    loader.stop()


def test_device_copy_failure_surfaces(fold, monkeypatch):
    loader = PrefetchLoader(CCTAPatchSampler([fold[0][0]], (8, 8, 8), 1, rng=np.random.default_rng(0)),
                            num_threads=1, prefetch=1, device="cpu")

    def boom(batch):
        raise RuntimeError("CUDA out of memory")

    monkeypatch.setattr(loader, "_transfer", boom)
    with pytest.raises(RuntimeError, match="prefetch worker failed"):
        next(loader)
    loader.stop()


@pytest.mark.parametrize("threads", [1, 2])
def test_finite_pass_ends_with_every_patient(fold, threads):
    paths = [p for p, _ in fold]
    loader = PrefetchLoader(CCTAPatchSampler(paths, PATCH, 2, rng=np.random.default_rng(1), infinite=False),
                            num_threads=threads, prefetch=2, to_device=False)
    names = [n for b in loader for n in b["name"]]
    assert sorted(names) == sorted(Path(p).stem for p in paths)
    loader.stop()


def test_cpu_loaders_hand_out_tensors_and_cuda_is_the_default(fold):
    loaders = tiny_loaders(fold)
    loaders = {k: PrefetchLoader(v.sampler, num_threads=1, prefetch=1, device="cpu") for k, v in loaders.items()}
    batch = next(loaders[0])
    assert isinstance(batch["data"], torch.Tensor) and batch["data"].dtype == torch.int16
    assert batch["data"].shape == (2, *PATCH) and "_ready" not in batch
    for loader in loaders.values():
        loader.stop()
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the rule under test is its absence")
    with pytest.raises(RuntimeError, match="cuda"):
        create_loaders(fold, PATCH, BATCH, np.random.default_rng(0))


def test_host_augmenter_in_the_loaders_is_resumable(fold):
    """Each loader's sampler gets its own augmenter generator, and the
    sampler state carries it."""
    cfg = aug.AugmentConfig(p_rotation=1.0, elastic_grid=4)
    from contrast_gan_3d_tpu_torch.data.host_augment import HostAugmenter

    template = HostAugmenter(cfg, np.random.default_rng(5))
    loaders = tiny_loaders(fold, augmenter=template)
    rngs = {id(l.sampler.augmenter.rng) for l in loaders.values()}
    assert len(rngs) == 3 and id(template.rng) not in rngs
    next(loaders[0])
    state = loaders[0].get_state()
    assert "augmenter_rng" in state
    want = next(loaders[0])["data"].copy()
    for loader in loaders.values():
        loader.stop()
    again = tiny_loaders(fold, augmenter=template)
    again[0].set_state(state)
    np.testing.assert_array_equal(next(again[0])["data"], want)
    for loader in again.values():
        loader.stop()


# --- checkpoints -------------------------------------------------------------


def _state_equal(a, b):
    for m in ("generator", "critic"):
        for (k, x), y in zip(getattr(a, m).state_dict().items(), getattr(b, m).state_dict().values()):
            torch.testing.assert_close(x, y, rtol=0, atol=0, msg=f"{m}.{k}")
    for o in ("gen_opt", "critic_opt"):
        sa, sb = getattr(a, o).optimizer.state_dict(), getattr(b, o).optimizer.state_dict()
        assert sa["param_groups"] == sb["param_groups"]
        for i in sa["state"]:
            for k in sa["state"][i]:
                torch.testing.assert_close(sa["state"][i][k], sb["state"][i][k], rtol=0, atol=0)
        assert getattr(a, o).scheduler.state_dict() == getattr(b, o).scheduler.state_dict()
    assert torch.equal(a.rng.get_state(), b.rng.get_state()) and a.step == b.step


def _trained(fold, iterations=3):
    t = tiny_trainer(iterations=iterations)
    t.fit(tiny_loaders(fold))
    return t


def test_checkpoint_round_trip_restores_the_whole_state(fold, tmp_path):
    t = _trained(fold)
    path = ckpt_lib.save_checkpoint(t.state, tmp_path, meta={"generator": {"norm": "batch"}})
    assert path.name == "3.pt" and (tmp_path / "3.meta.json").exists()
    fresh = tiny_trainer(seed=1)
    ckpt_lib.maybe_restore(fresh.state, tmp_path)
    _state_equal(fresh.state, t.state)
    # the restored state trains on exactly as the original does
    assert fresh.state.gen_opt.scheduler.milestones == t.state.gen_opt.scheduler.milestones
    payload = ckpt_lib.load_generator(tmp_path)
    assert payload["step"] == 3 and payload["meta"] == {"generator": {"norm": "batch"}}
    gen = ResnetGenerator(**GEN)
    gen.load_state_dict(payload["state_dict"], strict=True)
    assert ckpt_lib.maybe_restore(fresh.state, tmp_path / "none") is fresh.state
    with pytest.raises(FileNotFoundError):
        ckpt_lib.load_generator(tmp_path / "none")


def test_checkpoint_keep_prunes_with_sidecars(fold, tmp_path):
    t = tiny_trainer()
    loaders = {0: PrefetchLoader(CCTAPatchSampler([fold[0][0]], PATCH, 1), to_device=False)}
    for step in (2, 4, 6):
        ckpt_lib.save_checkpoint(t.state, tmp_path, step=step, keep=2, meta={})
        ckpt_lib.save_data_state(loaders, tmp_path, step)
    ckpt_lib.save_checkpoint(t.state, tmp_path, step=8, keep=2, meta={})
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["6.data.pkl", "6.meta.json", "6.pt", "8.meta.json", "8.pt"], names
    assert ckpt_lib.find_latest_checkpoint(tmp_path).name == "8.pt"
    with pytest.raises(ValueError):
        ckpt_lib.save_checkpoint(t.state, tmp_path, keep=0)


def test_async_write_failure_surfaces_at_the_next_save(tmp_path, monkeypatch):
    t = tiny_trainer()
    real_save = torch.save

    def boom(obj, f, *a, **k):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(ckpt_lib.torch, "save", boom)
    ckpt_lib.save_checkpoint(t.state, tmp_path, step=3, async_=True)
    with pytest.raises(RuntimeError, match="async checkpoint write"):
        ckpt_lib.flush_async_saves(tmp_path)
    ckpt_lib.save_checkpoint(t.state, tmp_path, step=5, async_=True)
    with pytest.raises(RuntimeError, match="async checkpoint write"):
        ckpt_lib.save_checkpoint(t.state, tmp_path, step=6)
    monkeypatch.setattr(ckpt_lib.torch, "save", real_save)
    ckpt_lib.save_checkpoint(t.state, tmp_path, step=7, async_=True)
    ckpt_lib.save_checkpoint(t.state, tmp_path, step=7)  # joins the async write of the same step
    assert [p.name for p in tmp_path.glob("*.pt")] == ["7.pt"]


def test_data_sidecar_round_trip_and_mismatches(fold, tmp_path):
    paths = [p for p, _ in fold]
    mk = lambda ps: PrefetchLoader(CCTAPatchSampler(ps, PATCH, 1, rng=np.random.default_rng(2)), num_threads=1,
                                   to_device=False)
    a = {0: mk(paths)}
    next(a[0])
    a[0].stop()
    path = ckpt_lib.save_data_state(a, tmp_path, 3)
    payload = pickle.loads(path.read_bytes())
    assert payload["format"] == 2 and payload["process_count"] == 1 and set(payload["loaders"]) == {0}
    b = {0: mk(paths)}
    assert ckpt_lib.maybe_restore_data_state(b, tmp_path, 3)
    assert b[0].get_state() == a[0].get_state()
    assert not ckpt_lib.maybe_restore_data_state({0: mk(paths[:2])}, tmp_path, 3)  # another patient list
    assert not ckpt_lib.maybe_restore_data_state({0: mk(paths), 1: mk(paths)}, tmp_path, 3)  # a loader more
    assert not ckpt_lib.maybe_restore_data_state(b, tmp_path, 9)  # no sidecar


# --- fit ---------------------------------------------------------------------


def test_fit_end_to_end(fold, tmp_path):
    """Logs every iteration (losses finite, ``patches_per_sec`` from the
    second conversion on, ``tb/`` seconds), validation at 2, images at 0
    and 3 through the preview (device augmentation) and at validation,
    the critic within the clip, periodic and final checkpoints, resume."""
    log = RecordingLogger()
    ckpt = tmp_path / "ckpt"
    t = tiny_trainer(ckpt, log=log)
    loaders = tiny_loaders(fold)
    state = t.fit(loaders, val_loaders=loaders)
    assert state.step == 4 and t.start_iteration == 0
    train_logs = [s for s in log.scalars if s[0] == "train"]
    val_logs = [s for s in log.scalars if s[0] == "validation"]
    assert [s[1] for s in train_logs] == [0, 1, 2, 3] and [s[1] for s in val_logs] == [2]
    assert all(np.isfinite(v) for _, _, s in log.scalars for v in s.values())
    assert [("patches_per_sec" in s) for _, _, s in train_logs] == [False, True, True, True]
    assert any(k.startswith("tb/") for _, _, s in train_logs for k in s)
    assert set(train_logs[0][2]) >= {"D", "G", "G-full", "sim", "HU"}
    tb = t.time_budget
    assert all(tb.total[p] > 0 for p in ("data_wait", "dispatch", "validation", "checkpoint", "images"))
    assert abs(sum(tb.shares().values()) - 1) < 1e-9 and "time budget over" in tb.summary()
    stages = [img[-1] for img in log.images]
    assert stages.count("train") == 2 and stages.count("validation") == 1
    sample, recon, atten, mask, names, step, stage = log.images[0]
    assert sample.shape == recon.shape == atten.shape == mask.shape == (2, *PATCH) and step == 0
    assert max(p.abs().max().item() for p in state.critic.parameters()) <= 0.01
    assert {"3.pt", "4.pt", "3.data.pkl", "4.data.pkl", "3.meta.json"} <= {p.name for p in ckpt.iterdir()}
    assert tiny_trainer(ckpt).iteration == 4


def test_resume_is_exactly_equal_to_uninterrupted(fold, tmp_path):
    """Four iterations straight against two, a checkpoint, and two more in
    a fresh trainer, with device augmentation: every parameter, statistic,
    optimizer state and the generator state identical."""
    t_a = tiny_trainer(tmp_path / "a")
    t_a.fit(tiny_loaders(fold))
    tiny_trainer(tmp_path / "b", iterations=2).fit(tiny_loaders(fold))
    t_b = tiny_trainer(tmp_path / "b", seed=9)  # another init: the checkpoint must win
    assert t_b.iteration == 2
    t_b.fit(tiny_loaders(fold))
    assert t_b.start_iteration == 2
    _state_equal(t_b.state, t_a.state)


def test_graceful_stop_checkpoints_and_resumes(fold, tmp_path):
    holder = {}

    class StopAt1(RecordingLogger):
        def log_scalars(self, scalars, step, stage="train"):
            super().log_scalars(scalars, step, stage)
            if stage == "train" and step >= 1:
                holder["t"].request_stop("test")

    t = holder["t"] = tiny_trainer(tmp_path, iterations=40, log=StopAt1(), val_every=None)
    prev = install_preemption_handler(t)
    try:
        state = t.fit(tiny_loaders(fold))
        assert t.stop_requested and 1 <= state.step < 40
        assert (tmp_path / f"{state.step}.pt").exists() and (tmp_path / f"{state.step}.data.pkl").exists()
        assert tiny_trainer(tmp_path, iterations=40).iteration == state.step
        # a signal while a stop is already requested escalates
        with pytest.raises(KeyboardInterrupt):
            signal.raise_signal(signal.SIGTERM)
    finally:
        for signum, handler in prev.items():
            signal.signal(signum, handler)


def test_fit_matches_jax_fit(fold):
    """Six iterations of the basic schedule (critic every 1, generator
    every 5): the same patient files and sampler seed, the same weights,
    no augmentation, f32, weight clip, a scalar log every iteration."""
    pair = Pair("wc", seed=5)
    iterations = 6
    common = dict(train_iterations=iterations, train_critic_every=1, train_generator_every=5, val_every=None,
                  log_every=1, log_images_every=None, checkpoint_every=None)
    jlog, plog = RecordingLogger(logs_images=False), RecordingLogger(logs_images=False)
    jt = jax_trainer.Trainer(pair.jgen, pair.jcritic, pair.tx, pair.tx, pair.jcfg,
                             jax_trainer.TrainerConfig(**common, cycle_length=1), jax.random.key(0), PATCH,
                             logger_interface=jlog, state=pair.jstate, auto_resume=False)
    jstate = jt.fit(jax_pipeline.create_loaders(fold, PATCH, BATCH, np.random.default_rng(13), num_threads=1,
                                                prefetch=2, to_device=False))
    pt = Trainer(pair.tgen, pair.tcritic, pair.tx_port, pair.tx_port, pair.cfg, TrainerConfig(**common),
                 logger_interface=plog, device="cpu")
    state = pt.fit(tiny_loaders(fold, seed=13))
    assert state.step == int(jstate.step) == iterations
    assert [s[1] for s in plog.scalars] == [s[1] for s in jlog.scalars] == list(range(iterations))
    for (_, it, got), (_, _, want) in zip(plog.scalars, jlog.scalars):
        keys = {k for k in want if not k.startswith("tb/") and k != "patches_per_sec"}
        assert keys and keys <= set(got)
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-5, err_msg=f"iteration {it} {k}")
    updates = {"generator": 2, "critic": iterations}
    for name, params, stats, carry in (
        ("generator", jstate.gen_params, jstate.gen_stats, generator_state_dict_from_jax),
        ("critic", jstate.critic_params, jstate.critic_stats, critic_state_dict_from_jax),
    ):
        want = carry({"params": _np_tree(params), "batch_stats": _np_tree(stats)})
        got = getattr(state, name).state_dict()
        for k, v in want.items():
            diff = np.abs(got[k].numpy() - v.numpy()).max()
            limit = 1e-4 if k.endswith(("running_mean", "running_var")) else 2 * pair.lr * updates[name]
            assert diff <= limit, (name, k, diff)


# --- config, builder, CLI ------------------------------------------------------


@pytest.mark.parametrize("name", list(jax_config.PRESETS))
def test_presets_equal_jax(name):
    got = dataclasses.asdict(config.PRESETS[name]())
    want = dataclasses.asdict(jax_config.PRESETS[name]())
    want.pop("xla_compiler_options")
    assert got == want


def _fields(obj, skip=()):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj) if f.name not in skip}


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("name", BUILDABLE)
def test_builder_matches_jax(name, backend):
    cfg = dataclasses.replace(config.PRESETS[name](), augment_backend=backend)
    jcfg = dataclasses.replace(jax_config.PRESETS[name](), augment_backend=backend)
    got, want = builder.build(cfg, device="cpu"), jax_builder.build(jcfg)
    # generator_layout auto resolves as in JAX: packed for every 3D preset
    assert got.generator.layout == want.generator.layout
    ps, js = got.step_config, want.step_config
    for f in ("weight_clip", "gp_weight", "gan_loss_weight", "sim_loss_weight", "hu_loss_weight", "hu_bounds",
              "gp_eps"):
        assert getattr(ps, f) == getattr(js, f), f
    assert _fields(ps.scaler) == _fields(js.scaler)
    assert str(ps.dtype).split(".")[-1] == jnp.dtype(js.dtype).name == "bfloat16"
    if backend == "device" or want.host_augmenter is None:
        assert got.host_augmenter is None and _fields(ps.augment) == _fields(js.augment)
    else:
        assert ps.augment is None and js.augment is None
        assert _fields(got.host_augmenter.cfg) == _fields(want.host_augmenter.cfg)
        assert got.host_augmenter.rng.bit_generator.state == want.host_augmenter.rng.bit_generator.state
    # cycle_length auto resolves as the JAX builder resolves it (K = 5 for
    # every preset but train_generator_more)
    assert _fields(got.trainer_config) == _fields(want.trainer_config)
    assert got.seed == want.seed
    if cfg.is_2d or cfg.critic_args.get("norm") == "layer":
        # the 2D family and the layer-norm critic: JAX's parameter counts
        shape = (1, *cfg.train_patch_size, 1)
        for ours, theirs in ((got.generator, want.generator), (got.critic, want.critic)):
            shapes = jax.eval_shape(partial(theirs.init, train=False), jax.random.key(0), jnp.zeros(shape))
            assert count_parameters(ours) == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
        assert type(got.host_augmenter).__name__ == type(want.host_augmenter).__name__
    else:
        assert count_parameters(got.critic) == (176_761 if cfg.weight_clip is None else 176_873)
        assert count_parameters(got.generator) == 1_035_297
    assert isinstance(got.logger_interface, ConsoleLogger)
    opt = got.gen_tx(got.generator.parameters())
    assert opt.optimizer.param_groups[0]["lr"] == cfg.lr
    assert type(opt.optimizer).__name__.lower() == cfg.optimizer


@pytest.mark.parametrize("change", [
    *[dict(preset=n) for n in UNPORTED],
    dict(generator_layout="packed"), dict(remat=True), dict(dp_devices=1),
    dict(sp_devices=2), dict(logger="wandb"), dict(logger="tensorboard"),
    dict(generator_args={**GEN, "norm": "instance"}, critic_args={**CRITIC, "norm": "instance"}),
    dict(generator_args={**GEN, "resnet_dropout_prob": 0.5}),
])
def test_builder_raises_for_what_is_not_ported(change):
    """``generator_layout="packed"`` raised until the packed layout was
    ported; it now builds the packed generator (and raises for the 2D
    family, as the packed generator does in JAX). ``dp_devices`` raised
    until data parallelism was ported: it now builds (the train CLI starts
    the ranks). ``remat=True``, instance norm and generator dropout raised
    until they were ported: each now builds, and its networks take a
    train step. ``sp_devices`` raised until spatial partitioning was
    ported: basic_3d now builds with the packed generator, as without a
    mesh (the direct layout until the packed one was partitioned); an
    explicit packed layout whose slabs would not hold whole blocks raises,
    naming the slabs' rows. The 2D family raised until its spatial
    partitioning was ported: conf_2d now builds its ndim-2 networks, the
    generator on the direct layout. ``logger="wandb"`` raised until it took the console logger
    where wandb cannot be imported, as the JAX builder does. The
    TensorBoard logger raised until it was ported: it now builds inside a
    ``MultiThreadedLogger``, as the JAX builder builds it (every logger's
    wiring against JAX's: ``tests/test_torch_port_logger.py``)."""
    change = dict(change)
    cfg = config.PRESETS[change.pop("preset", "basic_3d")]()
    if change == dict(dp_devices=1):
        assert builder.build(dataclasses.replace(cfg, **change), device="cpu").config.dp_devices == 1
        return
    if change == dict(sp_devices=2):
        built = builder.build(dataclasses.replace(cfg, **change), device="cpu")
        assert built.generator.layout == "packed" and built.config.sp_devices == 2
        with pytest.raises(ValueError, match=r"slabs of \[18\] rows"):
            builder.build(dataclasses.replace(cfg, generator_layout="packed", train_patch_size=(36, 128, 128),
                                              **change), device="cpu")
        built_2d = builder.build(dataclasses.replace(config.conf_2d(), **change), device="cpu")
        assert built_2d.config.sp_devices == 2 and built_2d.generator.layout == "direct"
        assert built_2d.generator.ndim == 2 and built_2d.critic.first.ndim == 2
        return
    if change == dict(generator_layout="packed"):
        assert builder.build(dataclasses.replace(cfg, **change), device="cpu").generator.layout == "packed"
        with pytest.raises(ValueError, match="3D-only"):
            builder.build(dataclasses.replace(config.conf_2d(), **change), device="cpu")
        return
    if change == dict(logger="wandb"):
        assert not has_wandb()  # not installed here (the card's machine has it; tests stub it)
        assert isinstance(builder.build(dataclasses.replace(cfg, **change), device="cpu").logger_interface,
                          ConsoleLogger)
        return
    if "logger" in change:
        built = builder.build(dataclasses.replace(cfg, **change), device="cpu")
        assert isinstance(built.logger_interface, MultiThreadedLogger)
        assert isinstance(built.logger_interface.inner, TensorBoardLogger)
        built.logger_interface.end_hook()
        return
    tiny = dict(generator_args=GEN, critic_args=CRITIC, train_patch_size=PATCH, val_patch_size=PATCH,
                compute_dtype="float32", augment=False)
    built = builder.build(dataclasses.replace(cfg, **{**tiny, **change}), device="cpu")
    gen, critic = built.generator, built.critic
    if "remat" in change:
        assert gen.remat and critic.remat
    elif "norm" in change["generator_args"]:
        assert gen.layout == "direct" and gen.norm == "instance"
        assert type(gen.first.norm).__name__ == type(critic.middle_0.norm).__name__ == "InstanceNorm"
    else:
        assert gen.layout == "packed" and gen.resnet_0.block0.dropout.p == 0.5
    trainer = Trainer(gen, critic, built.gen_tx, built.critic_tx, built.step_config,
                      dataclasses.replace(built.trainer_config, train_iterations=1), device="cpu")
    rng = np.random.default_rng(0)
    patches = {st: {"data": rng.integers(-500, 900, (n, *PATCH)).astype(np.int16),
                    "seg": (rng.random((n, *PATCH)) < 0.05).astype(np.int16)} for st, n in BATCH.items()}
    metrics, _ = trainer.train_step(patches, 0)
    assert trainer.iteration == 1 and all(np.isfinite(float(v)) for v in metrics.values())


def test_builder_resolves_the_automatic_choices(tmp_path):
    cfg = dataclasses.replace(config.basic_3d(), cycle_length=1, remat=False, generator_layout="direct",
                              logger="file", compute_dtype="float32", augment=False)
    built = builder.build(cfg, checkpoint_dir=str(tmp_path), device="cpu")
    assert built.step_config.augment is None and built.host_augmenter is None
    # the initial weights are the config seed's, whatever came before
    torch.manual_seed(123)
    again = builder.build(dataclasses.replace(cfg, logger="none"), device="cpu")
    for a, b in zip(built.generator.state_dict().values(), again.generator.state_dict().values()):
        assert torch.equal(a, b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            builder.build(cfg)
    assert built.step_config.dtype == torch.float32
    assert isinstance(built.logger_interface, MultiThreadedLogger)
    assert isinstance(built.logger_interface.inner, FileLogger)
    built.logger_interface.log_scalars({"D": 1.5, "G": float("nan")}, 3)
    line = (tmp_path / "metrics" / "scalars.jsonl").read_text()
    assert '"D": 1.5' in line and '"G": null' in line
    with pytest.raises(ValueError):
        builder.build(dataclasses.replace(cfg, augment_backend="gpu"), device="cpu")


def test_file_logger_without_a_checkpoint_dir_writes_under_the_logs_dir(tmp_path, monkeypatch):
    """As the JAX builder: ``<LOGS_DIR>/<name>/metrics``."""
    from contrast_gan_3d_tpu_torch import config as paths

    monkeypatch.setattr(paths, "LOGS_DIR", tmp_path / "logs")
    cfg = dataclasses.replace(config.basic_3d(), logger="file")
    built = builder.build(cfg, device="cpu")
    assert isinstance(built.logger_interface.inner, FileLogger) and built.trainer_config.checkpoint_dir is None
    built.logger_interface.log_scalars({"D": 0.5}, 1)
    assert '"D": 0.5' in (tmp_path / "logs" / "basic_3d" / "metrics" / "scalars.jsonl").read_text()


OVERRIDE = '''
from dataclasses import replace


def config(base):
    return replace(base, name="tiny", train_patch_size=(16, 16, 16), val_patch_size=(16, 16, 16),
                   train_batch_size={0: 2, -1: 1, 1: 1}, val_batch_size={0: 1, -1: 1, 1: 1},
                   generator_args={"n_resnet_blocks": 1, "n_updownsample_blocks": 1, "init_channels_out": 4},
                   critic_args={"init_channels_out": 4, "discriminator_depth": 2, "negative_slope": 0.2},
                   compute_dtype="float32", augment_backend="device", num_workers=(1, 1), log_every=2,
                   validate_every=3, val_iterations=1, checkpoint_every=3, logger="file")
'''


def test_cli_trains_checkpoints_and_resumes_on_the_cpu(fold, tmp_path):
    """``python -m contrast_gan_3d_tpu_torch.train`` for 4 iterations, then
    ``main`` in-process to 6: it resumes at 4."""
    conf, splits = tmp_path / "tiny.py", tmp_path / "splits.pkl"
    conf.write_text(OVERRIDE)
    splits.write_bytes(pickle.dumps({"train": [fold], "test": [fold]}))
    args = ["--conf", str(conf), "--cval-splits", str(splits), "--checkpoint-root", str(tmp_path / "runs"),
            "--run-id", "r", "--device", "cpu"]
    subprocess.run([sys.executable, "-m", "contrast_gan_3d_tpu_torch.train", *args, "--iterations", "4"],
                   check=True, cwd=Path(__file__).resolve().parents[1], timeout=120, capture_output=True)
    run = tmp_path / "runs" / "r"
    assert {"4.pt", "4.data.pkl", "4.meta.json"} <= {p.name for p in run.iterdir()}
    manager = train_cli.main([*args, "--iterations", "6", "--checkpoint-keep", "2"])
    trainer = manager.runs[0].trainer
    assert trainer.start_iteration == 4 and trainer.iteration == 6
    assert sorted(p.name for p in run.glob("*.pt")) == ["4.pt", "6.pt"]
    lines = (run / "metrics" / "scalars.jsonl").read_text().splitlines()
    assert any('"stage": "validation"' in line for line in lines)
    with pytest.raises(SystemExit):
        train_cli.main([*args, "--starting-fold", "3"])
