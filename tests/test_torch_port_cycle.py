"""Fused schedule cycles in the port vs the JAX package, on the CPU: the
builder's ``cycle_length`` auto, ``build_cycle_step``, ``Trainer.fit`` in
cycles, the split phases, the multistep schedule evaluated from the update
count, and the deterministic reflect pad.

On the CPU a cycle is the loop over the per-iteration steps (the card
replays it as a CUDA graph; ``chip_smoke.py`` holds the replays to eager
dispatch there), so a cycle equals the port's own per-iteration dispatch
bit for bit here. Sizes and tolerances are those of
``tests/test_torch_port_train.py`` (tiny networks, 16^3 patches, batch 2 +
1 + 1, weights carried from JAX, the gradient penalty with a fixed eps):
losses within 1e-5 absolute / 1e-4 relative, parameters within 2 lr with
99.9% of them within 2e-6 per update.
"""

import copy
import dataclasses
import logging
import types
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from contrast_gan_3d_tpu.experiments import builder as jax_builder
from contrast_gan_3d_tpu.experiments import config as jax_config
from contrast_gan_3d_tpu.trainer import optim as jax_optim
from contrast_gan_3d_tpu.trainer import steps as jax_steps
from contrast_gan_3d_tpu_torch.data import augment as aug
from contrast_gan_3d_tpu_torch.experiments import builder, config
from contrast_gan_3d_tpu_torch.models.blocks import ConvBlock, _conv_forward
from contrast_gan_3d_tpu_torch.models.discriminator import PatchGANDiscriminator
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.ops import block_conv
from contrast_gan_3d_tpu_torch.ops.s2d_conv import _axis_map, _axis_map_tensor, pad_spatial, reflect_pad
from contrast_gan_3d_tpu_torch.trainer import optim
from contrast_gan_3d_tpu_torch.trainer.steps import (
    StepConfig,
    build_cycle_step,
    build_train_steps,
    init_state,
    schedule_branches,
)
from contrast_gan_3d_tpu_torch.trainer.trainer import Trainer, TrainerConfig
from tests.test_torch_port_fit import RecordingLogger, _state_equal, fold, tiny_loaders, tiny_trainer  # noqa: F401
from tests.test_torch_port_train import Pair, assert_metrics_close, batches

PRESETS = ("basic_3d", "gradient_penalty", "small_patch", "gp_layernorm", "rmsprop", "train_generator_more",
           "conf_2d", "gradient_penalty_2d", "test_conf", "test_conf_2d")
PATTERN = ("combined", "critic", "critic", "critic", "critic")
# the critic's lr drops after its 2nd update: inside the cycle
CRITIC_MILESTONES, GEN_MILESTONES, GAMMA = (2,), (1,), 0.1


# --- cycle_length auto ----------------------------------------------------------


@pytest.mark.parametrize("name", PRESETS)
def test_resolve_cycle_length_matches_jax_for_every_preset(name):
    got = builder.resolve_cycle_length(config.PRESETS[name]())
    assert got == jax_builder.resolve_cycle_length(jax_config.PRESETS[name]())
    assert got == (1 if name == "train_generator_more" else 5)
    assert builder.build(config.PRESETS[name](), device="cpu").trainer_config.cycle_length == got


@pytest.mark.parametrize("stop_sync_every", [None, 10, 4])
@pytest.mark.parametrize("change", [
    dict(), dict(log_every=7), dict(log_images_every=None), dict(validate_every=12), dict(checkpoint_every=None),
    dict(train_generator_every=1), dict(train_generator_every=2), dict(train_generator_every=None),
    dict(cycle_length=3), dict(cycle_length=0), dict(train_critic_every=3),
])
def test_resolve_cycle_length_matches_jax_on_a_grid(change, stop_sync_every):
    got = builder.resolve_cycle_length(dataclasses.replace(config.basic_3d(), **change), stop_sync_every)
    want = jax_builder.resolve_cycle_length(dataclasses.replace(jax_config.basic_3d(), **change), stop_sync_every)
    assert got == want


# --- the cycle step ---------------------------------------------------------------


def _with_milestones(pair):
    """Both sides' optimizers with a critic milestone inside the cycle."""
    m = {"wc": dict(betas=(0.5, 0.999)), "gp": dict(betas=(0.0, 0.9))}[pair.mode]
    jtx = {n: jax_optim.make_optimizer(lr=pair.lr, milestones=ms, lr_gamma=GAMMA, **m)
           for n, ms in (("gen", GEN_MILESTONES), ("critic", CRITIC_MILESTONES))}
    pair.jstate = pair.jstate.replace(gen_opt=jtx["gen"].init(pair.jstate.gen_params),
                                      critic_opt=jtx["critic"].init(pair.jstate.critic_params))
    port = {n: partial(optim.make_optimizer, "adam", lr=pair.lr, milestones=ms, lr_gamma=GAMMA, **m)
            for n, ms in (("gen", GEN_MILESTONES), ("critic", CRITIC_MILESTONES))}
    return jtx, port


@pytest.mark.parametrize("mode", ["wc", "gp"])
def test_cycle_matches_jax_cycle_and_per_iteration_dispatch(mode):
    """One 5-iteration cycle (4 critic + 1 combined) with the critic's lr
    milestone after its 2nd update: the JAX ``build_cycle_step`` and the
    port's cycle agree within the train tolerances (parameters, statistics,
    metrics: D the mean over the critic updates); the port's cycle equals
    its per-iteration dispatch bit for bit (every tensor, the optimizers'
    state and schedules, the generator state, the step)."""
    pair = Pair(mode, seed=3)
    jtx, port_tx = _with_milestones(pair)
    data = batches(21, n=len(PATTERN))
    jsteps = jax_steps.build_train_steps(pair.jgen, pair.jcritic, jtx["gen"], jtx["critic"], pair.jcfg)
    jcycle = jax_steps.build_cycle_step(jsteps, PATTERN)
    stack = lambda i: jnp.stack([jnp.asarray(b[i]) for b in data])
    pair.jstate, want = jcycle(pair.jstate, stack(0), stack(1), stack(2))

    gen2, critic2 = copy.deepcopy(pair.tgen), copy.deepcopy(pair.tcritic)
    steps = build_train_steps(pair.cfg)
    state = init_state(pair.tgen, pair.tcritic, port_tx["gen"], port_tx["critic"], device="cpu")
    cycle = build_cycle_step(steps, PATTERN)
    tstack = lambda i: torch.stack([torch.from_numpy(b[i]) for b in data])
    state, got = cycle(state, tstack(0), tstack(1), tstack(2))
    assert cycle.calls == {"eager": 1, "capture": 0, "replay": 0}
    assert state.step == int(pair.jstate.step) == len(PATTERN)
    assert_metrics_close(got, want)
    pair.check(state, len(PATTERN))
    assert state.critic_opt.optimizer.param_groups[0]["lr"] == pytest.approx(pair.lr * GAMMA)

    ref = init_state(gen2, critic2, port_tx["gen"], port_tx["critic"], device="cpu")
    d_losses = []
    for branch, (o, s, m) in zip(PATTERN, data):
        fn = steps.combined_step if branch == "combined" else steps.critic_step
        ref, mt = fn(ref, o, s, m)
        d_losses.append(mt["D"])
    _state_equal(state, ref)
    assert torch.equal(got["D"], sum(d_losses) / len(d_losses))
    for k in ("G", "G-full", "sim", "HU"):
        assert k in got


@pytest.mark.parametrize("ndim", [2, 3])
def test_cycle_with_device_augmentation_equals_per_iteration_dispatch(ndim):
    """The port's own cycle against its per-iteration dispatch with the
    device augmentation on (draws from the state's generator), the GP
    branch resampling unequal batches, in 2D and 3D: bit-equal."""
    shape = (16, 16) if ndim == 2 else (16, 16, 16)
    augment = aug.Augment2DConfig() if ndim == 2 else aug.AugmentConfig(elastic_grid=4, p_rotation=0.5, p_elastic=0.5)
    cfg = StepConfig(weight_clip=None, augment=augment)
    tx = partial(optim.make_optimizer, "adam", lr=1e-3, milestones=[1])
    pattern = schedule_branches(2, 3, 0, 4)  # combined, none, critic, generator

    def fresh():
        torch.manual_seed(4)
        gen = ResnetGenerator(n_resnet_blocks=1, n_updownsample_blocks=1, init_channels_out=4, ndim=ndim)
        critic = PatchGANDiscriminator(init_channels_out=4, discriminator_depth=2, norm=None, ndim=ndim)
        return init_state(gen, critic, tx, tx, seed=2, device="cpu")

    rng = np.random.default_rng(8)
    opt = torch.from_numpy(rng.integers(-1024, 1500, (len(pattern), 3, *shape)).astype(np.int16))
    sub = torch.from_numpy(rng.integers(-1024, 1500, (len(pattern), 2, *shape)).astype(np.int16))
    msk = torch.from_numpy((rng.random((len(pattern), 2, *shape)) < 0.05).astype(np.int16))
    steps = build_train_steps(cfg)
    state, metrics = build_cycle_step(steps, pattern)(fresh(), opt, sub, msk)
    ref = fresh()
    fns = {"combined": steps.combined_step, "critic": steps.critic_step, "generator": steps.generator_only_step}
    for k, branch in enumerate(pattern):
        if branch == "none":
            ref.step += 1
        else:
            ref, _ = fns[branch](ref, opt[k], sub[k], msk[k])
    assert pattern == ("combined", "none", "critic", "generator") and state.step == ref.step == 4
    _state_equal(state, ref)
    assert set(metrics) == {"D", "G", "G-full", "sim", "HU"}


def test_cycle_none_branch_only_advances_the_step():
    pair = Pair("wc", seed=1)
    state = pair.port_state()
    before = {k: v.clone() for k, v in state.generator.state_dict().items()}
    rng_before = state.rng.get_state()
    (o, s, m), = batches(2)
    stack = lambda a: torch.stack([torch.from_numpy(a)] * 2)
    cycle = build_cycle_step(build_train_steps(pair.cfg), ("none", "none"))
    state, metrics = cycle(state, stack(o), stack(s), stack(m))
    assert metrics == {} and state.step == 2
    assert torch.equal(state.rng.get_state(), rng_before)
    for k, v in state.generator.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_launch_count_helpers_take_back_and_add():
    before = block_conv.launch_counts()
    assert set(fn for fn, _ in before) == set(block_conv.COUNTED)
    delta = {(block_conv.block_conv3x3x3, "launches"): 3, (block_conv.s2d_conv3d_block, "launches"): 2}
    block_conv.add_launch_counts(delta)
    after = block_conv.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == delta
    block_conv.add_launch_counts({k: -n for k, n in delta.items()})
    assert block_conv.launch_counts() == before


# --- the split phases --------------------------------------------------------------


@pytest.mark.parametrize("mode", ["wc", "gp"])
def test_split_phases_match_jax_and_the_combined_step(mode):
    """``critic_phase`` then ``generator_phase`` against JAX's phases (the
    train tolerances) and against the port's ``combined_step`` (bit for
    bit: the generator phase recomputes the same forward). The weights and
    batch of ``test_one_step_matches_jax``."""
    pair = Pair(mode)
    (opt, sub, msk), = batches(13)
    jsteps = jax_steps.build_train_steps(pair.jgen, pair.jcritic, pair.tx, pair.tx, pair.jcfg)
    jstate, jm1, jsub, jmask = jsteps.critic_phase(pair.jstate, opt, sub, msk)
    pair.jstate, jm2 = jsteps.generator_phase(jstate, jsub, jmask)
    gen2, critic2 = copy.deepcopy(pair.tgen), copy.deepcopy(pair.tcritic)
    steps = build_train_steps(pair.cfg)
    state = pair.port_state()
    state, m1, sub_s, mask_s = steps.critic_phase(state, opt, sub, msk)
    np.testing.assert_allclose(sub_s[:, 0].numpy(), np.asarray(jsub)[..., 0], atol=1e-6)
    np.testing.assert_array_equal(mask_s[:, 0].numpy(), np.asarray(jmask).reshape(mask_s[:, 0].shape))
    state, m2 = steps.generator_phase(state, sub_s, mask_s)
    assert_metrics_close({**m1, **m2}, {**jm1, **jm2})
    pair.check(state, 1)
    ref = init_state(gen2, critic2, pair.tx_port, pair.tx_port, device="cpu")
    ref, want = steps.combined_step(ref, opt, sub, msk)
    _state_equal(state, ref)
    for k, v in want.items():
        assert torch.equal({**m1, **m2}[k], v), k


def test_split_combined_forces_per_iteration_dispatch(caplog):
    pair = Pair("wc", seed=7)
    with caplog.at_level(logging.WARNING):
        t = Trainer(pair.tgen, pair.tcritic, pair.tx_port, pair.tx_port, pair.cfg,
                    TrainerConfig(cycle_length=5), device="cpu", split_combined=True)
    assert t.cfg.cycle_length == 1 and t.split_combined
    assert "split_combined=True: cycle_length=5 ignored" in caplog.text
    (o, s, m), = batches(3)
    patches = {0: {"data": o}, -1: {"data": s[:1], "seg": m[:1]}, 1: {"data": s[1:], "seg": m[1:]}}
    metrics, _ = t.train_step(patches, 0)
    assert set(metrics) == {"D", "G", "G-full", "sim", "HU"} and t.iteration == 1


def test_cadence_off_the_cycle_warns(caplog):
    pair = Pair("wc", seed=8)
    with caplog.at_level(logging.WARNING):
        Trainer(pair.tgen, pair.tcritic, pair.tx_port, pair.tx_port, pair.cfg,
                TrainerConfig(cycle_length=5, log_every=3, checkpoint_every=None), device="cpu")
    assert "log_every" in caplog.text and "checkpoint_every" not in caplog.text


# --- fit in cycles -------------------------------------------------------------------


def test_fit_in_cycles_equals_per_iteration_fit(fold):
    """12 iterations (critic every 1, generator every 5, device
    augmentation, images every 5 through the preview): K = 5 (two cycles and
    a tail of 2) against K = 1, bit-equal; the cycle run logs at its
    boundaries 0, 5, 10 the last generator losses and the mean critic loss
    of the cycle, from the per-iteration run's values."""
    common = dict(iterations=12, train_generator_every=5, val_every=None, checkpoint_every=None,
                  log_images_every=5)
    log1, log5 = RecordingLogger(), RecordingLogger()
    t1 = tiny_trainer(log=log1, log_every=1, **common)
    t1.fit(tiny_loaders(fold))
    t5 = tiny_trainer(log=log5, log_every=5, cycle_length=5, **common)
    t5.fit(tiny_loaders(fold))
    assert t5.state.step == t1.state.step == 12
    _state_equal(t5.state, t1.state)
    assert set(t5._cycle_cache) == {PATTERN, ("combined", "critic")}
    per_it = {it: sc for stage, it, sc in log1.scalars if stage == "train"}
    boundaries = [(it, sc) for stage, it, sc in log5.scalars if stage == "train"]
    assert [it for it, _ in boundaries] == [0, 5, 10]
    for it, sc in boundaries:
        for k in ("G", "G-full", "sim", "HU"):
            assert sc[k] == per_it[it][k], (it, k)
        ds = [torch.tensor(per_it[i]["D"], dtype=torch.float32) for i in range(it, min(it + 5, 12))]
        assert sc["D"] == float(sum(ds) / len(ds))
    assert [img[-2] for img in log5.images] == [img[-2] for img in log1.images if img[-2] % 5 == 0] == [0, 5, 10]
    for a, b in zip(log5.images, (img for img in log1.images if img[-2] % 5 == 0)):
        np.testing.assert_array_equal(a[0], b[0])  # the same augmented batch


def test_cycle_resume_realigns_boundaries(fold, tmp_path):
    """A run resumed mid-cycle gets one short first cycle, so later
    boundaries stay on multiples of K and the %-cadences keep firing."""
    kw = dict(train_generator_every=2, val_every=None, log_every=2, log_images_every=None, checkpoint_every=1,
              cycle_length=2)
    t = tiny_trainer(tmp_path / "ckpt", iterations=3, **kw)
    state = t.fit(tiny_loaders(fold))  # cycles at 0 (k=2) and 2 (k=1, the tail)
    assert state.step == 3
    log = RecordingLogger()
    t2 = tiny_trainer(tmp_path / "ckpt", iterations=7, log=log, **kw)
    state = t2.fit(tiny_loaders(fold))  # resumes at 3: cycles 3 (k=1), 4 (k=2), 6 (k=1)
    assert state.step == 7 and t2.start_iteration == 3
    assert [s for stage, s, _ in log.scalars if stage == "train"] == [4, 6]
    assert set(t2._cycle_cache) == {("critic",), ("combined", "critic"), ("combined",)}


def test_cycle_preview_skips_none_first_branch(fold):
    """critic every 4, generator every 3, K = 2: the cycle at 0 is
    ('combined', 'none') and renders its preview; the cycle at 2 is
    ('none', 'generator'), whose first branch draws nothing from the
    pre-cycle rng, so its preview is skipped."""
    log = RecordingLogger()
    t = tiny_trainer(log=log, iterations=4, train_critic_every=4, train_generator_every=3, val_every=None,
                     log_every=None, log_images_every=2, checkpoint_every=None, cycle_length=2)
    t.fit(tiny_loaders(fold))
    assert [img[-2:] for img in log.images] == [(0, "train")]


def test_first_flush_omits_patches_per_sec():
    """The first flushed boundary after a (re)start has no earlier fetch to
    measure from; later flushes carry ``patches_per_sec``."""
    log = RecordingLogger()
    t = types.SimpleNamespace(
        _pending_logs=[{"iteration": it, "metrics": {"D": torch.tensor(d)}, "event": None, "n_patches": 4, "tb": {}}
                       for it, d in ((10, 1.0), (20, 2.0))],
        _last_fetch=(0, None), logger_interface=log)
    Trainer._flush_oldest_log(t)
    Trainer._flush_oldest_log(t)
    first, second = (sc for _, _, sc in log.scalars)
    assert "patches_per_sec" not in first and second["patches_per_sec"] > 0


# --- the schedule from the update count ----------------------------------------------


def test_device_schedule_matches_optax_across_milestones():
    """``MultiStepSchedule.update_device_lr`` (the table lookup the card
    runs on its update count) against optax's piecewise schedule, update
    by update across unsorted milestones, to f32 rounding; with a repeated
    milestone (optax keeps one of the two, torch applies both) against
    ``MultiStepLR``, whose host values ``lr_at`` equals exactly."""
    lr, gamma = 0.3, 0.5
    for milestones, want in (([4, 2, 7], jax_optim.multistep_schedule(lr, [4, 2, 7], gamma)), ([4, 2, 4, 7], None)):
        sched = optim.MultiStepSchedule(lr, milestones, gamma, "cpu")
        sched.lr = torch.zeros(())
        p = torch.nn.Parameter(torch.zeros(1))
        torch_sched = torch.optim.lr_scheduler.MultiStepLR(torch.optim.SGD([p], lr=lr), milestones, gamma)
        for n in range(10):
            sched.count.fill_(n)
            sched.update_device_lr()
            host = torch_sched.get_last_lr()[0]
            assert sched.lr_at(n) == host
            np.testing.assert_allclose(float(sched.lr), float(want(n)) if want else host, rtol=1e-6)
            torch_sched.optimizer.step()
            torch_sched.step()


def test_schedule_restores_a_multisteplr_state():
    """Checkpoints written before the schedule moved to the update count
    hold ``MultiStepLR.state_dict()`` (milestones as a dict): they restore
    the count, the milestones and the next lr."""
    p = torch.nn.Parameter(torch.zeros(1))
    old = torch.optim.lr_scheduler.MultiStepLR(torch.optim.SGD([p], lr=0.2), [3, 5, 5], 0.1)
    for _ in range(6):
        old.optimizer.step()
        old.step()
    sd = dict(old.state_dict())
    sd["milestones"] = dict(sd["milestones"])
    opt = optim.make_optimizer("sgd", [torch.nn.Parameter(torch.zeros(1))], lr=0.2)
    opt.load_state_dicts(opt.optimizer.state_dict(), sd)
    assert int(opt.scheduler.count) == 6 and opt.scheduler.milestones == [3, 5, 5]
    assert opt.optimizer.param_groups[0]["lr"] == old.get_last_lr()[0]
    assert opt.state_dicts()[1]["last_epoch"] == 6


# --- the deterministic reflect pad ---------------------------------------------------


@pytest.mark.parametrize("shape,pads", [
    ((2, 3, 9, 7), ((3, 3), (3, 3))),
    ((2, 3, 5, 4), ((4, 2), (1, 3))),
    ((1, 2, 9, 8, 7), ((3, 3), (3, 3), (3, 3))),
    ((1, 2, 4, 5, 3), ((3, 1), (2, 4), (2, 2))),
])
def test_reflect_pad_equals_f_pad_forward_and_backward(shape, pads):
    """Forward bit-identical to ``F.pad(mode="reflect")``; backward too, on
    integer upstream gradients, whose sums are exact in any order (the two
    add the same contributions in another order)."""
    rng = np.random.default_rng(len(shape) * 10 + pads[0][0])
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    want = F.pad(x, flat, mode="reflect")
    dims = range(2, len(shape))
    got = reflect_pad(x, pads, dims)
    assert torch.equal(got, want)
    g = torch.from_numpy(rng.integers(-8, 9, want.shape).astype(np.float32))
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    F.pad(xa, flat, mode="reflect").backward(g)
    reflect_pad(xb, pads, dims).backward(g)
    assert torch.equal(xb.grad, xa.grad)
    if len(shape) == 5:  # pad_spatial, channels last
        cl = x.permute(0, 2, 3, 4, 1)
        assert torch.equal(pad_spatial(cl, pads, "reflect"), want.permute(0, 2, 3, 4, 1))
    with pytest.raises(ValueError, match="reflect pad"):
        reflect_pad(x, [(shape[2], 0)], [2])


@pytest.mark.parametrize("ndim", [2, 3])
def test_reflect_padded_conv_equals_the_module_conv(ndim):
    """The conv of a reflect-padded ``ConvBlock`` (the 2D stem, the 3D
    stem where the dims do not divide the s2d factor) against the conv
    module's own ``_conv_forward``, which pads with ``F.pad``:
    bit-identical, and the block runs it."""
    torch.manual_seed(ndim)
    block = ConvBlock(2, 3, 7, padding=3, padding_mode="reflect", norm="batch", activation=None, s2d=4, ndim=ndim)
    x = torch.randn((2, 2) + (9, 10, 11)[:ndim])
    conv_cls = torch.nn.Conv3d if ndim == 3 else torch.nn.Conv2d
    with torch.no_grad():
        want = conv_cls._conv_forward(block.conv, x, block.conv.weight, None)
        assert torch.equal(_conv_forward(block.conv, x, block.conv.weight), want)
        assert torch.equal(block._conv(x), want)


@pytest.mark.parametrize("k,f,s", [(7, 4, 1), (3, 4, 2), (5, 2, 1)])
def test_axis_map_built_on_the_device_equals_numpy(k, f, s):
    want, K = _axis_map(k, f, s)
    got = _axis_map_tensor(k, f, s, torch.float32, "cpu")
    assert got.shape[0] == K and torch.equal(got, torch.from_numpy(want))
