"""The model options the port took last: ``norm="instance"``, generator
dropout in training and remat, against the JAX package on the CPU.

Tiny sizes: generator ``n_resnet_blocks=1, n_updownsample_blocks=1,
init_channels_out=4`` on 16^3 (16^2) patches, critic
``init_channels_out=4, discriminator_depth=2`` on 32^3 (32^2). Tolerances:
- instance norm, f32: within 1e-5 of max|JAX| (flax's GroupNorm and the
  port's InstanceNorm reduce in another order);
- instance norm, bf16: ``tests/test_torch_port_bf16.py``'s rule, within
  twice JAX's own bf16 distance from its f32 result;
- dropout: JAX draws its masks from threefry keys and the port from the
  state's Philox generator, so masks cannot be equal bit for bit. Parity is
  held where it is defined: eval mode at p > 0 (the identity, as flax's
  ``deterministic`` dropout), the 1 / (1 - p) scale of the kept values,
  and the pattern of masks (one per iteration in the fused steps, shared
  by the critic's fake batch and the generator's gradient; a new one in
  the split phases' second forward; none drawn at p = 0);
- remat: the same steps with and without, bit-equal on the CPU (the
  recomputation repeats the forward's ops).
"""

import dataclasses
import logging
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from contrast_gan_3d_tpu.experiments import builder as jax_builder
from contrast_gan_3d_tpu.experiments import config as jax_config
from contrast_gan_3d_tpu.models.discriminator import PatchGANDiscriminator as JaxCritic
from contrast_gan_3d_tpu.models.generator import ResnetGenerator as JaxGenerator
from contrast_gan_3d_tpu_torch.data import augment as aug
from contrast_gan_3d_tpu_torch.eval.corrector import CCTAContrastCorrector
from contrast_gan_3d_tpu_torch.experiments import builder, config
from contrast_gan_3d_tpu_torch.models.blocks import Dropout
from contrast_gan_3d_tpu_torch.models.discriminator import PatchGANDiscriminator
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.models.norm import BatchNorm, InstanceNorm, recomputing
from contrast_gan_3d_tpu_torch.trainer import checkpoint as ckpt_lib
from contrast_gan_3d_tpu_torch.trainer.optim import make_optimizer
from contrast_gan_3d_tpu_torch.trainer.steps import StepConfig, build_train_steps, init_state
from contrast_gan_3d_tpu_torch.trainer.trainer import Trainer, TrainerConfig
from contrast_gan_3d_tpu_torch.utils.weights import critic_state_dict_from_jax, generator_state_dict_from_jax
from tests.test_torch_port_bf16 import assert_bf16_rule, jax_runs
from tests.test_torch_port_models import _np_tree

GEN = dict(n_resnet_blocks=1, n_updownsample_blocks=1, init_channels_out=4)
CRITIC = dict(init_channels_out=4, discriminator_depth=2)
TX = partial(make_optimizer, "adam", lr=1e-3)


def _randomize_instance_norms(variables, rng):
    """flax initialises GroupNorm at scale 1, bias 0; other values test the
    carried parameters."""
    def fill(tree, key=None):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v, k)
            elif key == "GroupNorm_0":
                out[k] = (rng.uniform(0.5, 1.5, v.shape) if k == "scale" else rng.normal(0, 0.2, v.shape)
                          ).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    return fill(variables)


def _channels_first(x: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.movedim(torch.from_numpy(np.asarray(x, np.float32)), -1, 1).to(dtype)


def _instance_pair(net, ndim, seed):
    """(JAX module, numpy variables, port module class, its kwargs, the
    state dict carried from JAX, input shape) for an instance-norm network."""
    if net == "generator":
        jcls, pcls, kw, carry, side = JaxGenerator, ResnetGenerator, GEN, generator_state_dict_from_jax, 16
    else:
        jcls, pcls, kw, carry, side = JaxCritic, PatchGANDiscriminator, CRITIC, critic_state_dict_from_jax, 32
    kw = dict(kw, norm="instance", ndim=ndim)
    shape = (2,) + (side,) * ndim + (1,)
    jmod = jcls(**kw)
    variables = _np_tree(jmod.init(jax.random.key(seed), jnp.zeros(shape), train=False))
    variables = _randomize_instance_norms(variables, np.random.default_rng(seed))
    return jcls, variables, pcls, kw, carry(variables), shape


@pytest.mark.parametrize("ndim", [3, 2])
@pytest.mark.parametrize("net", ["generator", "critic"])
def test_instance_norm_networks_match_jax_f32(net, ndim):
    jcls, variables, pcls, kw, sd, shape = _instance_pair(net, ndim, seed=21)
    x = np.random.default_rng(22).normal(0, 0.5, shape).astype(np.float32)
    want = np.asarray(jcls(**kw).apply(variables, jnp.asarray(x), train=True))
    port = pcls(**kw)
    port.load_state_dict(sd, strict=True)
    for train in (True, False):  # no running statistics: both modes agree
        port.train(train)
        with torch.no_grad():
            got = torch.movedim(port(_channels_first(x)), 1, -1).numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), (net, ndim, train)


@pytest.mark.parametrize("ndim", [3, 2])
@pytest.mark.parametrize("net", ["generator", "critic"])
def test_instance_norm_networks_match_jax_bf16(net, ndim):
    jcls, variables, pcls, kw, sd, shape = _instance_pair(net, ndim, seed=23)
    x = np.random.default_rng(24).normal(0, 0.5, shape).astype(np.float32)

    def run(dtype, jit, options):
        module = jcls(**kw, dtype=dtype)
        return jit(lambda v, a: module.apply(v, a, train=True))(variables, jnp.asarray(x, dtype))

    j32, j16s = jax_runs(run)
    port = pcls(**kw, dtype=torch.bfloat16)
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = torch.movedim(port(_channels_first(x, torch.bfloat16)), 1, -1)
    assert got.dtype == torch.bfloat16
    assert_bf16_rule(got, j16s, j32, f"{net} {ndim}D")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_norm_module_matches_flax_group_norm(rng, dtype):
    x = rng.normal(1.0, 2.0, (2, 5, 6, 7, 3)).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, 3).astype(np.float32), rng.normal(size=3).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias}}

    def run(jdtype, jit, options):
        gn = fnn.GroupNorm(num_groups=None, group_size=1, dtype=jdtype)
        return jit(lambda v, a: gn.apply(v, a))(variables, jnp.asarray(x, jdtype))

    norm = InstanceNorm(3, dtype=getattr(torch, dtype))
    norm.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    got = torch.movedim(norm(_channels_first(x, getattr(torch, dtype))), 1, -1).detach()
    j32, j16s = jax_runs(run)
    if dtype == "float32":
        assert np.abs(got.numpy() - np.asarray(j32)).max() <= 1e-5 * np.abs(np.asarray(j32)).max()
    else:
        assert_bf16_rule(got, j16s, j32, "InstanceNorm bf16")


def test_instance_norm_weights_are_carried():
    """flax ``GroupNorm_0/{scale,bias}`` -> ``norm.{weight,bias}``; no
    running statistics; every tensor of both networks covered, strictly."""
    for net in ("generator", "critic"):
        _, variables, pcls, kw, sd, _ = _instance_pair(net, 3, seed=25)
        port = pcls(**kw)
        assert set(sd) == set(port.state_dict())
        assert not any("running" in k for k in sd)
        port.load_state_dict(sd, strict=True)
        w = port.middle_0.norm.weight if net == "critic" else port.first.norm.weight
        key = "middle_0" if net == "critic" else "first"
        np.testing.assert_array_equal(w.detach().numpy(), variables["params"][key]["GroupNorm_0"]["scale"])


@pytest.mark.parametrize("norm", ["instance", "batch", None])
@pytest.mark.parametrize("name", ["basic_3d", "conf_2d"])
def test_layout_auto_resolves_as_jax(name, norm):
    """``generator_layout="auto"``: packed only for a 3D batch-norm
    generator; an instance-norm run is direct, so it trains and serves
    through B3 -> B1."""
    args = {"norm": norm}
    cfg = dataclasses.replace(config.PRESETS[name](), generator_args=args)
    jcfg = dataclasses.replace(jax_config.PRESETS[name](), generator_args=args)
    got = builder.build(cfg, device="cpu")
    assert builder.resolve_layout(cfg) == got.generator.layout == jax_builder.build(jcfg).generator.layout
    assert got.generator.layout == ("packed" if (name, norm) == ("basic_3d", "batch") else "direct")
    if norm == "instance":
        assert isinstance(got.generator.first.norm, InstanceNorm)


def test_instance_norm_run_checkpoint_rebuilds_the_generator(tmp_path):
    """The checkpoint meta records ``norm="instance"``; ``from_checkpoint``
    rebuilds an instance-norm generator from the weights and the meta and
    corrects as the trained one does."""
    torch.manual_seed(0)
    gen = ResnetGenerator(**GEN, norm="instance")
    trainer = Trainer(gen, PatchGANDiscriminator(**CRITIC, norm="instance"), TX, TX, StepConfig(),
                      TrainerConfig(checkpoint_dir=str(tmp_path)), device="cpu")
    ckpt_lib.save_checkpoint(trainer.state, tmp_path, meta=trainer._ckpt_meta)
    assert ckpt_lib.load_generator(tmp_path)["meta"] == {"generator": {"tconv_placement": "same",
                                                                          "norm": "instance"}}
    corrector = CCTAContrastCorrector.from_checkpoint(tmp_path, inference_patch_size=(16, 16, 16), device="cpu")
    assert corrector.generator.norm == "instance" and not corrector.packed
    vol = np.random.default_rng(36).normal(300, 200, (24, 20, 16)).astype(np.int16)
    want = CCTAContrastCorrector(gen.eval(), inference_patch_size=(16, 16, 16), device="cpu")(vol)
    torch.testing.assert_close(corrector(vol), want, rtol=0, atol=0)


# --- dropout ----------------------------------------------------------------


def test_dropout_eval_mode_matches_jax():
    """At p > 0 the eval-mode generator is the JAX one with
    ``train=False`` (flax's dropout is then the identity)."""
    kw = dict(GEN, resnet_dropout_prob=0.5)
    jgen = JaxGenerator(**kw)
    x = np.random.default_rng(31).normal(0, 0.5, (2, 16, 16, 16, 1)).astype(np.float32)
    variables = _np_tree(jgen.init(jax.random.key(31), jnp.zeros(x.shape), train=False))
    want = np.asarray(jgen.apply(variables, jnp.asarray(x), train=False))
    port = ResnetGenerator(**kw)
    port.load_state_dict(generator_state_dict_from_jax(variables), strict=True)
    port.eval()
    with torch.no_grad():
        got = torch.movedim(port(_channels_first(x)), 1, -1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("p", [0.25, 0.5])
def test_dropout_scales_kept_values_as_flax(p):
    """Kept values are x / (1 - p), dropped ones 0, in x's dtype, as flax's
    train-mode dropout; the mask comes from the given generator alone."""
    x = np.random.default_rng(32).normal(0, 1, (4, 3, 8, 8, 8)).astype(np.float32)
    want = np.asarray(fnn.Dropout(p, deterministic=False).apply({}, jnp.asarray(x),
                                                               rngs={"dropout": jax.random.key(0)}))
    flax_kept = want != 0
    np.testing.assert_allclose(want[flax_kept], (x / (1 - p))[flax_kept], rtol=1e-6)
    drop = Dropout(p)
    drop.generator = torch.Generator().manual_seed(5)
    global_before = torch.get_rng_state()
    for dtype in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).to(dtype)
        got = drop(xt)
        assert got.dtype == dtype
        kept = got != 0
        torch.testing.assert_close(got[kept], xt[kept] / (1 - p), rtol=0, atol=0)
        assert abs(kept.float().mean().item() - (1 - p)) < 0.05
        assert abs(flax_kept.mean() - (1 - p)) < 0.05
    assert torch.equal(torch.get_rng_state(), global_before)
    with pytest.raises(RuntimeError, match="generator"):
        Dropout(p)(torch.from_numpy(x))
    drop.eval()
    assert drop(torch.from_numpy(x)) is not None and torch.equal(drop(torch.from_numpy(x)), torch.from_numpy(x))


def _batches(seed, n=2, side=16):
    rng = np.random.default_rng(seed)
    b = lambda: rng.integers(-300, 700, (n,) + (side,) * 3).astype(np.int16)
    return b(), b(), (rng.random((n,) + (side,) * 3) < 0.05).astype(np.int16)


def _record_masks(generator):
    """The masks each dropout module draws (recomputations excluded)."""
    masks = []

    def hook(module, args, out):
        if not recomputing():
            masks.append(module.mask)

    for m in generator.modules():
        if isinstance(m, Dropout):
            m.register_forward_hook(hook)
    return masks


def test_dropout_shares_one_mask_per_fused_iteration_and_redraws_in_split_phases():
    """JAX's fused steps take the mask from ``fold_in(k_aug, 7)`` once per
    iteration; its ``generator_phase`` redraws from the state's key. The
    port's fused steps run one forward (one mask, shared by the critic's
    fake batch and the generator's gradient); the split phases two."""
    torch.manual_seed(0)
    gen = ResnetGenerator(**GEN, resnet_dropout_prob=0.5)
    state = init_state(gen, PatchGANDiscriminator(**CRITIC), TX, TX, device="cpu")
    masks = _record_masks(gen)
    steps = build_train_steps(StepConfig())
    opt, sub, mask = _batches(33)
    steps.combined_step(state, opt, sub, mask)
    assert len(masks) == 1  # one ResNet block, one dropout
    steps.critic_step(state, opt, sub, mask)
    steps.generator_only_step(state, opt, sub, mask)
    assert len(masks) == 3
    _, _, sub_s, mask_s = steps.critic_phase(state, opt, sub, mask)
    steps.generator_phase(state, sub_s, mask_s)
    assert len(masks) == 5 and not torch.equal(masks[3], masks[4])
    keep = torch.stack(masks).float().mean().item()
    assert 0.4 < keep < 0.6


def test_dropout_draws_from_the_state_generator_and_none_at_p0():
    """A generator without dropout consumes ``state.rng`` exactly as before
    dropout was ported (the augmentation draws alone); with dropout the
    masks come from ``state.rng`` after them, never from torch's global
    generator."""
    cfg = StepConfig(augment=aug.AugmentConfig(elastic_grid=4))
    opt, sub, mask = _batches(34)
    states = {}
    for p in (0.0, 0.5):
        torch.manual_seed(0)
        gen = ResnetGenerator(**GEN, resnet_dropout_prob=p)
        state = init_state(gen, PatchGANDiscriminator(**CRITIC), TX, TX, seed=7, device="cpu")
        global_before = torch.get_rng_state()
        build_train_steps(cfg).combined_step(state, opt, sub, mask)
        assert torch.equal(torch.get_rng_state(), global_before)
        states[p] = state.rng.get_state()
    by_hand = torch.Generator().manual_seed(7)
    for n in (len(sub), len(opt)):
        aug.draw(by_hand, n, cfg.augment)
    assert torch.equal(states[0.0], by_hand.get_state())
    assert not torch.equal(states[0.5], by_hand.get_state())


# --- remat --------------------------------------------------------------------


def _remat_run(remat, layout, weight_clip, dropout):
    torch.manual_seed(1)
    gen = ResnetGenerator(**GEN, layout=layout, remat=remat, resnet_dropout_prob=dropout)
    critic = PatchGANDiscriminator(**CRITIC, norm="batch" if weight_clip else None, remat=remat)
    state = init_state(gen, critic, TX, TX, device="cpu")
    updates = []

    def count(module, args, out):
        if module.training and not recomputing():
            updates.append(module)

    for m in [*gen.modules(), *critic.modules()]:
        if isinstance(m, BatchNorm):
            m.register_forward_hook(count)
    steps = build_train_steps(StepConfig(weight_clip=weight_clip, gp_eps=None if weight_clip else 0.3))
    opt, sub, mask = _batches(35)
    metrics = [steps.combined_step(state, opt, sub, mask)[1]]
    _, m, sub_s, mask_s = steps.critic_phase(state, opt, sub, mask)
    metrics += [m, steps.generator_phase(state, sub_s, mask_s)[1]]
    sd = {**{f"G.{k}": v for k, v in gen.state_dict().items()}, **{f"D.{k}": v for k, v in critic.state_dict().items()}}
    return metrics, sd, len(updates), state.rng.get_state()


@pytest.mark.parametrize("layout,weight_clip,dropout", [
    ("direct", 0.01, 0.0), ("packed", 0.01, 0.0), ("direct", None, 0.5), ("direct", 0.01, 0.5),
])
def test_remat_steps_equal_the_steps_without(layout, weight_clip, dropout):
    """Weight clip and the gradient penalty (whose double backward runs
    through the critic's checkpointed blocks), both layouts, with and
    without dropout: metrics, weights, BatchNorm statistics (updated once
    per forward, not again in the recomputation: the statistics-updating
    forwards are counted) and the random stream are bit-equal, so the
    recomputation applied its forward's dropout mask."""
    plain = _remat_run(False, layout, weight_clip, dropout)
    remat = _remat_run(True, layout, weight_clip, dropout)
    for got, want in zip(remat[0], plain[0]):
        assert got.keys() == want.keys()
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    assert remat[1].keys() == plain[1].keys()
    for k in plain[1]:
        torch.testing.assert_close(remat[1][k], plain[1][k], rtol=0, atol=0, msg=k)
    assert remat[2] == plain[2] > 0
    assert torch.equal(remat[3], plain[3])


def test_builder_honours_remat_and_logs_the_jax_rule(caplog):
    """An explicit ``remat`` builds remat networks (``generator_args`` win);
    None stays off, with a log line where JAX's 30 M-voxel rule would turn
    it on (``small_patch``: 40 + 20 + 20 x 128x128x32)."""
    for remat in (True, False):
        built = builder.build(dataclasses.replace(config.basic_3d(), remat=remat), device="cpu")
        assert built.generator.remat is built.critic.remat is remat
    built = builder.build(dataclasses.replace(config.basic_3d(), remat=True, generator_args={"remat": False}),
                          device="cpu")
    assert built.generator.remat is False and built.critic.remat is True
    builder._remat_logged.clear()
    with caplog.at_level(logging.INFO, logger=builder.logger.name):
        built = builder.build(config.small_patch(), device="cpu")
        builder.build(config.small_patch(), device="cpu")
    assert built.generator.remat is False
    assert sum("remat stays off" in r.message for r in caplog.records) == 1
    assert jax_builder.build(jax_config.small_patch()).generator.remat is True
