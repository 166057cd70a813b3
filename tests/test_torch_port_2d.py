"""The port's 2D family and layer-norm critic vs the JAX package, on the
CPU: the 2D ``ConvBlock``, generator and critic (f32 and bf16), ``norm=
"layer"``, the 4-D kernels of ``utils/weights.py``, the 2D slice corrector,
the 2D samplers and device augmentation, the native 2D warp and
``HostAugmenter2D``, the 2D patch sampler and loaders, the 2D train and
validation steps, and the CLI on a tiny ``conf_2d``.

Sizes are tiny: generator ``n_resnet_blocks=2, n_updownsample_blocks=2,
init_channels_out=4`` (``ndim=2``) on 32^2 slices, critic
``init_channels_out=4, discriminator_depth=2``, batch 2 + 1 + 1. Inputs are
made with numpy from a seed; weights are carried from JAX with
``utils/weights.py``. Tolerances, and why:
- forwards and gradients: those of the 3D tests (1e-4 of the output or of
  each gradient tensor's max, BatchNorm statistics 1e-5): f32 sums in
  another order over a few convolutions;
- bf16: the three-way rule of ``tests/test_torch_port_bf16.py``;
- the corrector: 0.1 HU per volume, as for 3D;
- samplers and device augmentation: 1e-5 of max|image| (the same f32
  blend; rotated coordinates 1e-5 pixel apart); masks equal wherever no
  coordinate lies within 1e-4 of a half-integer;
- the native warp, ``HostAugmenter2D`` and the sampler and loader batches:
  bit-identical (the same C++ source and the same numpy draws); the native
  warp against its plain version: every pixel within 1 HU, 99.9% equal;
- steps: the train-step parity tolerances of ``tests/test_torch_port_
  train.py``; the CLI's ``fit``: 1e-3 relative per logged loss.
"""

import dataclasses
import json
import pickle
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from contrast_gan_3d_tpu import native as jax_native
from contrast_gan_3d_tpu.data import augment as jax_aug
from contrast_gan_3d_tpu.data import pipeline as jax_pipeline
from contrast_gan_3d_tpu.data import preprocess as jax_preprocess
from contrast_gan_3d_tpu.data.host_augment import HostAugmenter2D as JaxHostAugmenter2D
from contrast_gan_3d_tpu.data.sampler import CCTAPatchSampler as JaxSampler
from contrast_gan_3d_tpu.eval.corrector import CCTAContrastCorrector as JaxCorrector
from contrast_gan_3d_tpu.experiments import builder as jax_builder
from contrast_gan_3d_tpu.experiments import config as jax_config
from contrast_gan_3d_tpu.models.blocks import ConvBlock as JaxConvBlock
from contrast_gan_3d_tpu.models.discriminator import PatchGANDiscriminator as JaxCritic
from contrast_gan_3d_tpu.models.generator import ResnetGenerator as JaxGenerator
from contrast_gan_3d_tpu.ops import resample as jax_rs
from contrast_gan_3d_tpu.trainer import optim as jax_optim
from contrast_gan_3d_tpu.trainer import steps as jax_steps
from contrast_gan_3d_tpu.trainer import trainer as jax_trainer
from contrast_gan_3d_tpu.utils.torch_port import critic_variables_from_torch, generator_variables_from_torch
from contrast_gan_3d_tpu_torch import native
from contrast_gan_3d_tpu_torch import train as train_cli
from contrast_gan_3d_tpu_torch.data import augment as aug
from contrast_gan_3d_tpu_torch.data.host_augment import HostAugmenter2D, warp2d_int16
from contrast_gan_3d_tpu_torch.data.pipeline import create_loaders
from contrast_gan_3d_tpu_torch.data.sampler import CCTAPatchSampler
from contrast_gan_3d_tpu_torch.eval.corrector import CCTAContrastCorrector
from contrast_gan_3d_tpu_torch.experiments.builder import build
from contrast_gan_3d_tpu_torch.experiments.config import load_config
from contrast_gan_3d_tpu_torch.models.blocks import ConvBlock, S2DConv
from contrast_gan_3d_tpu_torch.models.discriminator import PatchGANDiscriminator
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.models.norm import LayerNorm
from contrast_gan_3d_tpu_torch.ops import resample as rs
from contrast_gan_3d_tpu_torch.trainer import optim
from contrast_gan_3d_tpu_torch.trainer.logger import FileLogger2D
from contrast_gan_3d_tpu_torch.trainer.steps import (
    StepConfig,
    build_preview_step,
    build_train_steps,
    build_val_steps,
    init_state,
)
from contrast_gan_3d_tpu_torch.utils.reference_checkpoint import (
    critic_state_dict_to_reference,
    generator_state_dict_to_reference,
)
from contrast_gan_3d_tpu_torch.utils.weights import critic_state_dict_from_jax, generator_state_dict_from_jax
from tests.synth import synthetic_patient
from tests.test_torch_port_bf16 import _f64, _grad_sd, _recording, assert_bf16_rule, assert_rule_per_tensor, carried, \
    jax_runs
from tests.test_torch_port_fit import RecordingLogger
from tests.test_torch_port_models import _np_tree, randomize_norms
from tests.test_torch_port_train import assert_metrics_close, assert_params_close

GEN = dict(n_resnet_blocks=2, n_updownsample_blocks=2, init_channels_out=4, ndim=2)
CRITIC = dict(init_channels_out=4, discriminator_depth=2, ndim=2)
PATCH = (32, 32)
B_OPT, B_LOW, B_HIGH = 2, 1, 1
GP_EPS = 0.3
MODES = {
    "wc": dict(norm="batch", lr=2e-4, betas=(0.5, 0.999), weight_clip=0.01),
    "gp": dict(norm=None, lr=1e-4, betas=(0.0, 0.9), weight_clip=None),
}


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def nchw(a, dtype=torch.float32):
    """Channels-last (B, X, Y, C) numpy -> NCHW tensor."""
    return _t(a, dtype).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1)


def carried_2d(jax_cls, port_cls, cfg, seed, **kw):
    """(jax module, numpy variables, port module with the same weights)."""
    jm = jax_cls(**cfg, **kw)
    variables = jm.init(jax.random.key(seed), jnp.zeros((1, *PATCH, 1)), train=False)
    variables = randomize_norms(_np_tree(variables), np.random.default_rng(seed))
    pm = port_cls(**cfg, **kw)
    carry = generator_state_dict_from_jax if port_cls is ResnetGenerator else critic_state_dict_from_jax
    pm.load_state_dict(carry(variables), strict=True)
    return jm, variables, pm


# --- blocks, models, weights --------------------------------------------------

BLOCKS = {
    "conv3-batch": dict(features=6, kernel_size=3, padding=1, norm="batch", activation="relu"),
    "stem-reflect-bias": dict(features=5, kernel_size=7, padding=3, padding_mode="reflect", norm=None,
                              activation="tanh", s2d=4),
    "down-stride2": dict(features=6, kernel_size=3, stride=2, padding=1, norm="batch", activation="relu"),
    "tconv-same": dict(features=6, kernel_size=3, stride=2, transpose=True, norm="batch"),
    "tconv-torch": dict(features=6, kernel_size=3, stride=2, transpose=True, norm="batch", tconv_placement="torch"),
    "critic-layer": dict(features=6, kernel_size=4, stride=2, padding=1, norm="layer", activation="leaky_relu"),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_2d_conv_block_forward_and_gradients_match_jax(name):
    """Train mode: the output, the input gradient and every parameter
    gradient of sum(out * r), and the BatchNorm statistics."""
    kw = dict(BLOCKS[name], ndim=2)
    rng = np.random.default_rng(1)
    x = rng.normal(0, 0.5, (2, 12, 10, 3)).astype(np.float32)
    jb = JaxConvBlock(**kw)
    variables = randomize_norms(_np_tree(jb.init(jax.random.key(2), jnp.asarray(x), train=False)), rng)
    pkw = {k: v for k, v in kw.items() if k != "features"}
    pb = ConvBlock(3, kw["features"], **pkw)
    pb.load_state_dict(generator_state_dict_from_jax(variables), strict=True)
    if kw.get("s2d"):
        assert not isinstance(pb.conv, S2DConv)  # 2D never takes space-to-depth

    def f(params, xx):
        out, upd = jb.apply({**variables, "params": params}, xx, train=True, mutable=["batch_stats"])
        return jnp.sum(out * r), (out, upd)

    out_shape = jax.eval_shape(lambda: jb.apply(variables, jnp.asarray(x), train=False)).shape
    r = rng.normal(size=out_shape).astype(np.float32)
    (_, (want, upd)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, variables["params"]), jnp.asarray(x))
    xt = nchw(x).requires_grad_(True)
    pb.train()
    got = pb(xt)
    names, params = zip(*pb.named_parameters())
    grads = torch.autograd.grad((got * nchw(r)).sum(), (xt, *params))
    np.testing.assert_allclose(nhwc(got).numpy(), np.asarray(want), atol=1e-4 * np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(nhwc(grads[0]).numpy(), np.asarray(gx), atol=1e-4 * np.abs(np.asarray(gx)).max())
    wg = generator_state_dict_from_jax({"params": _np_tree(gp)})
    for n, g in zip(names, grads[1:]):
        w = wg[n].numpy()
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max() + 1e-7, err_msg=n)
    if "batch_stats" in upd:
        want_sd = generator_state_dict_from_jax({"params": variables["params"], "batch_stats": _np_tree(
            upd["batch_stats"])})
        for k, v in pb.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), atol=1e-5, err_msg=k)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("placement", ["same", "torch"])
def test_2d_generator_matches_jax(train, placement):
    jgen, variables, tgen = carried_2d(JaxGenerator, ResnetGenerator, GEN, 3, tconv_placement=placement)
    assert not any(isinstance(m, S2DConv) for m in tgen.modules())  # s2d_factor=4 is ignored in 2D
    x = np.random.default_rng(4).normal(0, 0.5, (3, *PATCH, 1)).astype(np.float32)
    if train:
        want, upd = jgen.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = jgen.apply(variables, jnp.asarray(x), train=False)
    tgen.train(train)
    with torch.no_grad():
        got = nhwc(tgen(nchw(x)))
    assert got.shape == want.shape == (3, *PATCH, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    if train:
        want_sd = generator_state_dict_from_jax({"params": variables["params"],
                                                 "batch_stats": _np_tree(upd["batch_stats"])})
        for k, v in tgen.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), atol=1e-5, err_msg=k)


def test_2d_generator_gradients_match_jax():
    jgen, variables, tgen = carried_2d(JaxGenerator, ResnetGenerator, GEN, 5)
    rng = np.random.default_rng(6)
    x = rng.normal(0, 0.5, (2, *PATCH, 1)).astype(np.float32)
    r = rng.normal(size=(2, *PATCH, 1)).astype(np.float32)

    def jax_loss(params):
        out, _ = jgen.apply({"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x),
                            train=True, mutable=["batch_stats"])
        return jnp.sum(out * r)

    wgrads = generator_state_dict_from_jax({"params": _np_tree(jax.grad(jax_loss)(
        jax.tree.map(jnp.asarray, variables["params"])))})
    tgen.train()
    names, params = zip(*tgen.named_parameters())
    grads = torch.autograd.grad((tgen(nchw(x)) * nchw(r)).sum(), params)
    for name, g in zip(names, grads):
        w = wgrads[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("norm", ["batch", None, "layer"])
@pytest.mark.parametrize("train", [False, True])
def test_2d_critic_matches_jax(norm, train):
    jc, variables, tc = carried_2d(JaxCritic, PatchGANDiscriminator, dict(CRITIC, norm=norm), 7)
    x = np.random.default_rng(8).normal(0, 0.5, (3, *PATCH, 1)).astype(np.float32)
    if train and norm == "batch":
        want, _ = jc.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = jc.apply(variables, jnp.asarray(x), train=train)
    tc.train(train)
    with torch.no_grad():
        got = nhwc(tc(nchw(x)))
    assert got.shape == want.shape == (3, 3, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_conf_2d_widths_match_jax_parameter_counts():
    """``conf_2d``'s generator (6 ResNet blocks, width 16) and critic (16
    channels, 4x4 kernels) have JAX's parameter counts."""
    cfg = jax_config.conf_2d()
    for jcls, pcls, args in ((JaxGenerator, ResnetGenerator, cfg.generator_args),
                             (JaxCritic, PatchGANDiscriminator, cfg.critic_args)):
        shapes = jax.eval_shape(partial(jcls(**args).init, train=False), jax.random.key(0),
                                jnp.zeros((1, 64, 64, 1)))
        want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
        assert sum(p.numel() for p in pcls(**args).parameters()) == want


def test_weights_carry_4d_kernels():
    """2D conv kernels (kx, ky, I, O) -> (O, I, kx, ky); transpose-conv
    kernels flipped on both spatial axes -> (I, O, kx, ky)."""
    _, variables, tgen = carried_2d(JaxGenerator, ResnetGenerator, GEN, 9)
    p = variables["params"]
    np.testing.assert_array_equal(tgen.first.conv.weight.detach().numpy(),
                                  p["first"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(tgen.up_0.conv.weight.detach().numpy(),
                                  p["up_0"]["ConvTranspose_0"]["kernel"][::-1, ::-1].transpose(2, 3, 0, 1))
    assert tgen.first.conv.weight.dim() == 4


@pytest.mark.parametrize("shape", [(2, 5, 6, 4), (2, 3, 5, 4, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_flax(rng, shape, dtype):
    """Per-sample normalisation over every non-batch axis, f32 statistics,
    the output in the input's dtype: flax's rounding (bf16: the port's
    output equals flax's to one bf16 ulp)."""
    x = rng.normal(1.0, 2.0, shape).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    mod = fnn.LayerNorm(reduction_axes=tuple(range(1, len(shape))), use_bias=False, use_scale=False, dtype=jdt)
    want = np.asarray(mod.apply({}, jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    got = LayerNorm(dtype=tdt)(_t(x, tdt)).float().numpy()
    tol = 1e-5 if dtype == "float32" else 2.0**-7 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol)


@pytest.mark.parametrize("net", ["generator", "critic"])
def test_2d_models_bf16_match_jax(net):
    """The 2D generator (train mode: output and every gradient) and the
    layer-norm critic (output) in bf16, by the three-way rule."""
    if net == "generator":
        variables, make, mod = carried(JaxGenerator, ResnetGenerator, GEN, (1, *PATCH, 1),
                                       generator_state_dict_from_jax, 11)
    else:
        variables, make, mod = carried(JaxCritic, PatchGANDiscriminator, dict(CRITIC, norm="layer"),
                                       (1, *PATCH, 1), critic_state_dict_from_jax, 12)
    carry = generator_state_dict_from_jax if net == "generator" else critic_state_dict_from_jax
    rng = np.random.default_rng(13)
    x = rng.normal(0, 0.5, (2, *PATCH, 1)).astype(np.float32)
    out_shape = (2, *PATCH, 1) if net == "generator" else (2, 3, 3, 1)
    r = rng.normal(size=out_shape).astype(np.float32)

    def run(dtype, jit, _):
        module = make(dtype)

        def f(params):
            out, _ = module.apply({**variables, "params": params}, jnp.asarray(x), train=True,
                                  mutable=["batch_stats"])
            return jnp.sum(out.astype(jnp.float32) * r), out

        (_, out), grads = jit(jax.value_and_grad(f, has_aux=True))(jax.tree.map(jnp.asarray, variables["params"]))
        return out, carry({"params": _np_tree(grads)})

    (o32, g32), j16s = jax_runs(run)
    mod.train()
    out = mod(nchw(x))
    assert out.dtype == torch.bfloat16
    assert_bf16_rule(nhwc(out), [j[0] for j in j16s], o32, f"{net} output")
    names, params = zip(*mod.named_parameters())
    grads = torch.autograd.grad((out.float() * nchw(r)).sum(), params)
    assert_rule_per_tensor(dict(zip(names, grads)), [j[1] for j in j16s], g32, f"{net} grad")


# --- the 2D corrector -----------------------------------------------------------


@pytest.mark.parametrize("depth,batch_size", [(13, 8), (5, None), (16, 4)])
def test_2d_corrector_matches_jax(depth, batch_size):
    """Axial slices in batches of min(batch_size, ceil(D/8)*8), the tail
    zero-padded: D=13 pads 3 slices, D=5 runs one batch of 8, D=16 four
    full batches. 0.1 HU per volume."""
    jgen, variables, tgen = carried_2d(JaxGenerator, ResnetGenerator, GEN, 14)
    vol = np.random.default_rng(15).integers(-1024, 1500, (*PATCH, depth)).astype(np.int16)
    want = JaxCorrector(jgen, variables["params"], variables["batch_stats"], inference_patch_size=PATCH,
                        batch_size=batch_size)(vol)
    corrector = CCTAContrastCorrector(tgen, inference_patch_size=PATCH, batch_size=batch_size, device="cpu")
    assert corrector.is_2d and corrector.batch_size == (batch_size or 8)
    got = corrector(vol)
    assert got.dtype == torch.float32 and tuple(got.shape) == vol.shape
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 0.1


def test_2d_corrector_zero_generator_is_identity():
    tgen = ResnetGenerator(**GEN)
    with torch.no_grad():
        tgen.last_conv.conv.weight.zero_()
        tgen.last_conv.conv.bias.zero_()
    vol = np.random.default_rng(16).integers(-1024, 1500, (*PATCH, 3)).astype(np.int16)
    got = CCTAContrastCorrector(tgen, inference_patch_size=PATCH, device="cpu")(vol)
    np.testing.assert_allclose(got.numpy(), vol, atol=1e-3)


# --- resampling and device augmentation ------------------------------------------


@pytest.mark.parametrize("channels", [None, 2])
def test_2d_samplers_match_jax(rng, channels):
    shape = (2, 7, 9) + ((channels,) if channels else ())
    img = rng.normal(0, 100, shape).astype(np.float32)
    coords = rng.uniform(-8, 14, (2, 5, 4, 2)).astype(np.float32)
    coords[0, 0, 0] = [-30.0, 100.5]  # deep out of bounds on both axes
    got = rs.bilinear_sample(_t(img), _t(coords)).numpy()
    want = np.stack([np.asarray(jax_rs.bilinear_sample(jnp.asarray(i), jnp.asarray(c))) for i, c in zip(img, coords)])
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(img).max())
    got_n = rs.nearest_sample_2d(_t(img), _t(coords)).numpy()
    want_n = np.stack([np.asarray(jax_rs.nearest_sample_2d(jnp.asarray(i), jnp.asarray(c)))
                       for i, c in zip(img, coords)])
    np.testing.assert_array_equal(got_n, want_n)


def test_2d_nearest_rounds_half_to_even_and_identity_grid():
    img = np.arange(8 * 8, dtype=np.float32).reshape(1, 8, 8)
    half = np.array([[0.5, 1.5], [2.5, 3.5], [-0.5, 7.5]], np.float32)[None]
    got = rs.nearest_sample_2d(_t(img), _t(half)).numpy()[0]
    np.testing.assert_array_equal(got, np.asarray(jax_rs.nearest_sample_2d(jnp.asarray(img[0]), jnp.asarray(half[0]))))
    ix = np.clip(np.round(half[0]).astype(int), 0, 7)
    np.testing.assert_array_equal(got, img[0][ix[:, 0], ix[:, 1]])
    np.testing.assert_array_equal(rs.identity_grid((3, 5)).numpy(), np.asarray(jax_rs.identity_grid_2d((3, 5))))


def jax_draws_2d(key, batch: int, cfg) -> aug.AugmentDraws2D:
    """The draws JAX's 2D ``augment_batch(..., key, cfg)`` makes: per sample
    ``split(key, 5)`` -> angle, rotation gate, mirror gate, x flip, y flip
    (``data/augment.py:123-149``)."""
    rows = []
    for k in jax.random.split(key, batch):
        k_rot, k_rot_p, k_mir_p, k_mir_x, k_mir_y = jax.random.split(k, 5)
        rows.append((
            jax.random.bernoulli(k_rot_p, cfg.p_rotation),
            jax.random.uniform(k_rot, (), minval=-cfg.angle, maxval=cfg.angle),
            jax.random.bernoulli(k_mir_p, cfg.p_mirror),
            jax.random.bernoulli(k_mir_x, 0.5),
            jax.random.bernoulli(k_mir_y, 0.5),
        ))
    return aug.AugmentDraws2D(*(torch.from_numpy(np.stack([np.asarray(r[i]) for r in rows])) for i in range(5)))


def near_half(coords: torch.Tensor, tol=1e-4) -> torch.Tensor:
    frac = torch.remainder(coords, 1.0)
    return ((frac - 0.5).abs() < tol).any(-1)


@pytest.mark.parametrize("probs", [dict(p_rotation=1.0, p_mirror=1.0), {}])
@pytest.mark.parametrize("shape", [(16, 16), (12, 20)])
def test_2d_augment_batch_matches_jax(probs, shape):
    jcfg, cfg = jax_aug.Augment2DConfig(**probs), aug.Augment2DConfig(**probs)
    rng = np.random.default_rng(17)
    data = rng.integers(-1024, 1500, (6, *shape)).astype(np.float32)
    seg = (rng.random((6, *shape)) < 0.2).astype(np.float32)
    key = jax.random.key(18)
    want_d, want_s = jax_aug.augment_batch(jnp.asarray(data), jnp.asarray(seg), key, jcfg)
    draws = jax_draws_2d(key, 6, jcfg)
    got_d, got_s = aug.augment_batch(_t(data), _t(seg), draws, cfg)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-5 * np.abs(data).max())
    safe = ~near_half(aug.coords_from_draws_2d(draws, shape, cfg)).numpy()
    np.testing.assert_array_equal(got_s.numpy()[safe], np.asarray(want_s)[safe])
    assert safe.mean() > 0.99
    opt_only, none = aug.augment_batch(_t(data), None, draws, cfg)
    assert none is None
    torch.testing.assert_close(opt_only, got_d, rtol=0, atol=0)


def test_2d_draw_is_reproducible_and_gated():
    cfg = aug.Augment2DConfig()
    a = aug.draw(torch.Generator().manual_seed(4), 64, cfg)
    b = aug.draw(torch.Generator().manual_seed(4), 64, cfg)
    assert isinstance(a, aug.AugmentDraws2D)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert 0 < int(a.rot_gate.sum()) < 64 and 0 < int(a.mirror_gate.sum()) < 64
    assert a.angle.abs().max() <= 2 * np.pi
    off = a._replace(rot_gate=torch.zeros(64, dtype=torch.bool), mirror_gate=torch.zeros(64, dtype=torch.bool))
    torch.testing.assert_close(aug.coords_from_draws_2d(off, (8, 8), cfg),
                               rs.identity_grid((8, 8)).expand(64, 8, 8, 2), rtol=0, atol=0)


# --- the native 2D warp and the host augmenter -------------------------------------


def _slice_case(rng, shape, angle, mx, my):
    x = np.linspace(-1, 1, shape[0])[:, None]
    scan = (800 * np.sin(4 * x) * np.cos(np.linspace(0, 3, shape[1]))[None, :]
            + rng.normal(0, 20, shape)).astype(np.int16)
    seg = (rng.random(shape) < 0.3).astype(np.int16)
    c, s = np.float32(np.cos(angle)), np.float32(np.sin(angle))
    affine = np.diag([mx, my]).astype(np.float32) @ np.array([[c, -s], [s, c]], np.float32)
    return scan, seg, affine


@pytest.mark.parametrize("shape,angle,mx,my", [((32, 32), 0.7, 1, 1), ((37, 21), -2.9, -1, 1),
                                               ((128, 128), 5.1, 1, -1), ((16, 40), 0.0, -1, -1)])
def test_warp2d_bit_identical_to_jax_native(rng, shape, angle, mx, my):
    scan, seg, affine = _slice_case(rng, shape, angle, mx, my)
    calls = native.warp_augment2d_int16.calls
    got = native.warp_augment2d_int16(scan, seg, affine)
    assert native.warp_augment2d_int16.calls == calls + 1
    want = jax_native.warp_augment2d_int16(scan, seg, affine)
    for g, w in zip(got, want):
        assert g.dtype == np.int16
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shape", [(32, 32), (37, 21)])
def test_native_warp2d_against_its_plain_version(rng, shape):
    n_equal = n = 0
    calls = warp2d_int16.calls
    for angle in (0.3, 1.9, -4.0):
        scan, seg, affine = _slice_case(rng, shape, angle, -1, 1)
        (ns, nm), (ps, pm) = native.warp_augment2d_int16(scan, seg, affine), warp2d_int16(scan, seg, affine)
        assert np.abs(ns.astype(np.int32) - ps).max() <= 1
        n_equal += int((ns == ps).sum())
        n += scan.size
        center = (np.asarray(shape, np.float32) - 1) / 2
        coords = (rs.identity_grid(shape) - _t(center)) @ _t(affine).T + _t(center)
        safe = ~near_half(coords).numpy()
        np.testing.assert_array_equal(nm[safe], pm[safe])
    assert warp2d_int16.calls == calls + 3
    assert n_equal / n >= 0.999


def test_host_augmenter_2d_bit_identical_to_jax(rng):
    """The same numpy seed: the same draws, the same native warp, so the
    same slices; an untouched slice comes back as it is."""
    cfg, jcfg = aug.Augment2DConfig(), jax_aug.Augment2DConfig()
    paug, jaug = HostAugmenter2D(cfg, np.random.default_rng(3)), JaxHostAugmenter2D(jcfg, np.random.default_rng(3))
    n_same = 0
    for _ in range(16):
        scan, seg, _ = _slice_case(rng, (24, 20), 0.0, 1, 1)
        (gs, gm), (ws, wm) = paug(scan, seg), jaug(scan, seg)
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gm, wm)
        n_same += gs is scan
    assert 0 < n_same < 16
    assert paug.rng.bit_generator.state == jaug.rng.bit_generator.state
    clone = dataclasses.replace(paug, rng=np.random.default_rng(0))
    assert clone._lock is not paug._lock


# --- the 2D patch sampler and loaders --------------------------------------------------


@pytest.fixture(scope="module")
def fold_2d(tmp_path_factory):
    """Two patients per label, in-plane larger than the 32^2 patch, and one
    LOW patient smaller than it (the padding paths)."""
    root = tmp_path_factory.mktemp("patients_2d")
    rng = np.random.default_rng(0)
    fold = []
    for label in (0, -1, 1):
        for i in range(2):
            vol, mask, _, meta = synthetic_patient(rng, (40, 36, 10))
            fold.append((str(jax_preprocess.write_patient(vol, mask, meta, f"p{label}_{i}", root)), label))
    vol, mask, _, meta = synthetic_patient(rng, (24, 20, 6))
    fold.append((str(jax_preprocess.write_patient(vol, mask, meta, "small", root)), -1))
    return fold


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("infinite", [True, False])
def test_2d_sampler_batches_bit_identical_to_jax(fold_2d, augment, infinite):
    paths = [p for p, _ in fold_2d]
    kw = dict(infinite=infinite, shuffle=infinite)
    jaug = JaxHostAugmenter2D(jax_aug.Augment2DConfig(), np.random.default_rng(5)) if augment else None
    paug = HostAugmenter2D(aug.Augment2DConfig(), np.random.default_rng(5)) if augment else None
    js = JaxSampler(paths, PATCH, 3, rng=np.random.default_rng(11), augmenter=jaug, **kw)
    ps = CCTAPatchSampler(paths, PATCH, 3, rng=np.random.default_rng(11), augmenter=paug, **kw)
    assert ps.is_2d
    n = 0
    for jb, pb in zip(js, ps):
        for k in ("data", "seg"):
            assert pb[k].dtype == np.int16 and pb[k].shape[1:] == PATCH
            np.testing.assert_array_equal(pb[k], jb[k])
        assert pb["name"] == jb["name"]
        n += 1
        if n == 6:
            break
    assert n == (6 if infinite else 3)  # 7 patients in batches of 3
    assert ps.get_state()["rng"] == js.get_state()["rng"]


def test_2d_loader_batches_bit_identical_to_jax(fold_2d):
    """The loaders as the CLI builds them for conf_2d: host augmentation
    (HostAugmenter2D cloned per label) and p_centerline_3d 0."""
    batch = {0: 2, -1: 1, 1: 1}
    kw = dict(num_threads=1, prefetch=2, to_device=False, p_centerline_3d=0.0)
    jl = jax_pipeline.create_loaders(fold_2d, PATCH, batch, np.random.default_rng(3),
                                     augmenter=JaxHostAugmenter2D(jax_aug.Augment2DConfig(), np.random.default_rng(4)),
                                     **kw)
    pl = create_loaders(fold_2d, PATCH, batch, np.random.default_rng(3),
                        augmenter=HostAugmenter2D(aug.Augment2DConfig(), np.random.default_rng(4)), **kw)
    try:
        for _ in range(4):
            for label in (0, -1, 1):
                jb, pb = next(jl[label]), next(pl[label])
                np.testing.assert_array_equal(np.asarray(pb["data"]), jb["data"])
                np.testing.assert_array_equal(np.asarray(pb["seg"]), jb["seg"])
    finally:
        for ls in (jl, pl):
            for loader in ls.values():
                loader.stop()


# --- the 2D steps --------------------------------------------------------------


class Pair2D:
    """The same initial 2D train state on both sides, for one mode."""

    def __init__(self, mode, seed=0, critic_norm=None, **step_kw):
        m = MODES[mode]
        self.lr = m["lr"]
        self.jgen, gvars, self.tgen = carried_2d(JaxGenerator, ResnetGenerator, GEN, seed)
        norm = critic_norm or m["norm"]
        self.jcritic, cvars, self.tcritic = carried_2d(JaxCritic, PatchGANDiscriminator, dict(CRITIC, norm=norm),
                                                       seed + 1)
        gp_eps = None if m["weight_clip"] else GP_EPS
        self.tx = jax_optim.make_optimizer(lr=m["lr"], betas=m["betas"])
        self.jcfg = jax_steps.StepConfig(**{**dict(weight_clip=m["weight_clip"], augment=None, dtype=jnp.float32,
                                                   gp_eps=gp_eps), **step_kw.get("jax", {})})
        self.cfg = StepConfig(weight_clip=m["weight_clip"], gp_eps=gp_eps, **step_kw.get("port", {}))
        as_j = lambda t: jax.tree.map(jnp.asarray, t)
        self.jstate = jax_steps.GANTrainState(
            step=jnp.zeros((), jnp.int32),
            gen_params=as_j(gvars["params"]), gen_stats=as_j(gvars["batch_stats"]),
            critic_params=as_j(cvars["params"]), critic_stats=as_j(cvars.get("batch_stats", {})),
            gen_opt=self.tx.init(as_j(gvars["params"])), critic_opt=self.tx.init(as_j(cvars["params"])),
            rng=jax.random.key(seed),
        )
        self.tx_port = partial(optim.make_optimizer, "adam", lr=m["lr"], betas=m["betas"])

    def port_state(self):
        return init_state(self.tgen, self.tcritic, self.tx_port, self.tx_port, seed=0, device="cpu")

    def check(self, state, steps_taken):
        j = self.jstate
        for module, params, stats, carry, what in (
            (state.generator, j.gen_params, j.gen_stats, generator_state_dict_from_jax, "generator"),
            (state.critic, j.critic_params, j.critic_stats, critic_state_dict_from_jax, "critic"),
        ):
            want = carry({"params": _np_tree(params), "batch_stats": _np_tree(stats)})
            got = module.state_dict()
            assert set(got) == set(want), what
            for k, v in want.items():
                if k.endswith(("running_mean", "running_var")):
                    np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-5, err_msg=f"{what}.{k}")
                else:
                    assert_params_close(got[k].numpy(), v.numpy(), self.lr, steps_taken, f"{what}.{k}")


def slice_batches(seed, mask_p=0.05):
    rng = np.random.default_rng(seed)
    opt = rng.integers(-1024, 1500, (B_OPT, *PATCH)).astype(np.int16)
    sub = rng.integers(-1024, 1500, (B_LOW + B_HIGH, *PATCH)).astype(np.int16)
    msk = (rng.random((B_LOW + B_HIGH, *PATCH)) < mask_p).astype(np.int16)
    return opt, sub, msk


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("branch", ["critic_step", "combined_step", "generator_only_step"])
def test_2d_step_matches_jax(mode, branch):
    """(B, X, Y) int16 slices in, (B, 1, X, Y) through the networks."""
    pair = Pair2D(mode, seed=2)
    opt, sub, msk = slice_batches(20)
    jsteps = jax_steps.build_train_steps(pair.jgen, pair.jcritic, pair.tx, pair.tx, pair.jcfg)
    pair.jstate, want = getattr(jsteps, branch)(pair.jstate, opt, sub, msk)
    state, got = getattr(build_train_steps(pair.cfg), branch)(pair.port_state(), opt, sub, msk)
    assert state.step == 1
    assert_metrics_close(got, want)
    pair.check(state, 1)


def test_gp_step_with_the_layer_norm_critic_matches_jax():
    """``gp_layernorm``'s critic (per-sample LayerNorm over the whole map,
    no affine, no bias) in a gradient-penalty ``combined_step``, 3D as the
    preset trains it."""
    from tests.test_torch_port_train import Pair, batches, carried_critic

    pair = Pair("gp", seed=3)
    pair.jcritic, cvars, pair.tcritic = carried_critic(4, norm="layer")
    assert not any(k.endswith("bias") for k in cvars["params"]["middle_0"]["Conv_0"])
    pair.jstate = pair.jstate.replace(critic_params=jax.tree.map(jnp.asarray, cvars["params"]), critic_stats={},
                                      critic_opt=pair.tx.init(jax.tree.map(jnp.asarray, cvars["params"])))
    (opt, sub, msk), = batches(21)
    jsteps = jax_steps.build_train_steps(pair.jgen, pair.jcritic, pair.tx, pair.tx, pair.jcfg)
    pair.jstate, want = jsteps.combined_step(pair.jstate, opt, sub, msk)
    state, got = build_train_steps(pair.cfg).combined_step(pair.port_state(), opt, sub, msk)
    assert_metrics_close(got, want)
    pair.check(state, 1)


class JaxKeyDraws2D:
    """The port's ``draw`` fed with JAX's 2D draws: the sub-optimal batch's
    (JAX's k2) first, then the OPT batch's (k1)."""

    def __init__(self, rng_key, jcfg):
        _, k_aug, _ = jax.random.split(rng_key, 3)
        k1, k2 = jax.random.split(k_aug)
        self.keys, self.jcfg, self.calls = [k2, k1], jcfg, []

    def __call__(self, generator, batch, cfg):
        d = jax_draws_2d(self.keys[len(self.calls)], batch, self.jcfg)
        self.calls.append(d)
        return d


def test_2d_combined_step_with_device_augmentation_matches_jax():
    probs = dict(p_rotation=1.0, p_mirror=1.0)
    jcfg, cfg = jax_aug.Augment2DConfig(**probs), aug.Augment2DConfig(**probs)
    pair = Pair2D("wc", seed=5, jax=dict(augment=jcfg), port=dict(augment=cfg))
    opt, sub, msk = slice_batches(22, mask_p=0.2)
    jsteps = jax_steps.build_train_steps(pair.jgen, pair.jcritic, pair.tx, pair.tx, pair.jcfg)
    draws = JaxKeyDraws2D(pair.jstate.rng, jcfg)
    pair.jstate, want = jsteps.combined_step(pair.jstate, opt, sub, msk)
    state, got = build_train_steps(pair.cfg, draw=draws).combined_step(pair.port_state(), opt, sub, msk)
    assert len(draws.calls) == 2 and draws.calls[0].angle.shape[0] == len(sub)
    assert_metrics_close(got, want)
    pair.check(state, 1)


def test_2d_preview_is_the_batch_the_step_trained_on():
    pair = Pair2D("wc", seed=6)
    cfg = dataclasses.replace(pair.cfg, augment=aug.Augment2DConfig(p_rotation=1.0, p_mirror=1.0))
    seen = []

    def recording_draw(generator, batch, c):
        seen.append(aug.draw(generator, batch, c))
        return seen[-1]

    opt, sub, msk = slice_batches(23, mask_p=0.2)
    state = pair.port_state()
    rng_before = state.rng.get_state()
    state, _ = build_train_steps(cfg, draw=recording_draw).critic_step(state, opt, sub, msk)
    want_sub, want_mask = aug.augment_batch(_t(sub), _t(msk), seen[0], cfg.augment)
    x, x_hat, atten, mask = build_preview_step(cfg)(state, rng_before, sub, msk)
    torch.testing.assert_close(x[:, 0], cfg.scaler(want_sub), rtol=0, atol=0)
    torch.testing.assert_close(mask[:, 0], want_mask, rtol=0, atol=0)
    assert x.shape == (len(sub), 1, *PATCH) and torch.equal(x_hat, x - atten)


@pytest.mark.parametrize("mode", list(MODES))
def test_2d_combined_step_bf16_matches_jax(mode):
    """One bf16 2D ``combined_step`` (conf_2d's weight clip and
    gradient_penalty_2d's fixed-eps penalty): losses and every gradient by
    the three-way rule, the Adam-updated parameters within 2 lr."""
    m = MODES[mode]
    gvars, make_gen, gen = carried(JaxGenerator, ResnetGenerator, GEN, (1, *PATCH, 1),
                                   generator_state_dict_from_jax, 24)
    cvars, make_critic, critic = carried(JaxCritic, PatchGANDiscriminator, dict(CRITIC, norm=m["norm"]),
                                         (1, *PATCH, 1), critic_state_dict_from_jax, 25)
    opt, sub, msk = slice_batches(26)
    gp_eps = None if m["weight_clip"] else GP_EPS
    tx = _recording(jax_optim.make_optimizer(lr=m["lr"], betas=m["betas"]))
    as_j = lambda t: jax.tree.map(jnp.asarray, t)
    carries = {"generator": generator_state_dict_from_jax, "critic": critic_state_dict_from_jax}

    def run(dtype, _, options):
        cfg = jax_steps.StepConfig(weight_clip=m["weight_clip"], augment=None, dtype=dtype, gp_eps=gp_eps,
                                   compiler_options=options)
        state = jax_steps.GANTrainState(
            step=jnp.zeros((), jnp.int32), gen_params=as_j(gvars["params"]), gen_stats=as_j(gvars["batch_stats"]),
            critic_params=as_j(cvars["params"]), critic_stats=as_j(cvars.get("batch_stats", {})),
            gen_opt=tx.init(as_j(gvars["params"])), critic_opt=tx.init(as_j(cvars["params"])),
            rng=jax.random.key(0))
        state, metrics = jax_steps.build_train_steps(make_gen(dtype), make_critic(dtype), tx, tx, cfg).combined_step(
            state, opt, sub, msk)
        grads, sd = {}, {}
        for net, (params, g) in {"generator": (state.gen_params, state.gen_opt[0]),
                                 "critic": (state.critic_params, state.critic_opt[0])}.items():
            grads.update({f"{net}.{k}": v for k, v in _grad_sd(g, carries[net]).items()})
            sd.update({f"{net}.{k}": v for k, v in carries[net]({"params": _np_tree(params)}).items()})
        return {k: float(v) for k, v in metrics.items()}, grads, sd

    (m32, g32, s32), j16s = jax_runs(run)
    tx_port = partial(optim.make_optimizer, "adam", lr=m["lr"], betas=m["betas"])
    state = init_state(gen, critic, tx_port, tx_port, seed=0, device="cpu")
    cfg = StepConfig(weight_clip=m["weight_clip"], gp_eps=gp_eps, dtype=torch.bfloat16)
    state, metrics = build_train_steps(cfg).combined_step(state, opt, sub, msk)
    assert_rule_per_tensor({k: v.float() for k, v in metrics.items()}, [j[0] for j in j16s], m32, "metric")
    got = {f"{net}.{n}": p.grad for net in carries for n, p in getattr(state, net).named_parameters()}
    assert_rule_per_tensor(got, [j[1] for j in j16s], g32, "grad")
    for k, want in s32.items():
        net, name = k.split(".", 1)
        v = dict(getattr(state, net).named_parameters())[name]
        for w in (want, *(j[2][k] for j in j16s)):
            assert np.abs(_f64(v) - _f64(w)).max() <= 2 * m["lr"] * (1 + 1e-3), k


def test_2d_val_steps_match_jax():
    pair = Pair2D("wc", seed=7)
    jopt, jsub = jax_steps.build_val_steps(pair.jgen, pair.jcritic, pair.jcfg)
    batch = np.random.default_rng(27).integers(-1024, 1500, (3, *PATCH)).astype(np.int16)
    w = np.array([1, 1, 0], np.float32)
    state = pair.port_state()
    vopt, vsub = build_val_steps(pair.cfg)
    np.testing.assert_allclose(float(vopt(state, batch, w)), float(jopt(pair.jstate, batch, w)), rtol=1e-4, atol=1e-6)
    got, want = vsub(state, batch, w), jsub(pair.jstate, batch, w)
    for g, wv in zip(got[:2], want[:2]):
        np.testing.assert_allclose(float(g), float(wv), rtol=1e-4, atol=1e-6)
    for g, wv in zip(got[2:], want[2:]):
        np.testing.assert_allclose(nhwc(g).numpy(), np.asarray(wv), atol=1e-4)


# --- the CLI on a tiny conf_2d ---------------------------------------------------

# conf_2d's changes to basic_3d (``experiments/config.py``), then tiny
# widths, 32^2 slices, f32 and short cadences
OVERRIDE_2D = '''
from dataclasses import replace


def config(base):
    return replace(base, name="tiny_conf_2d", is_2d=True, train_patch_size=(32, 32), val_patch_size=(32, 32),
                   train_batch_size={0: 2, -1: 1, 1: 1}, val_batch_size={0: 2, -1: 1, 1: 1},
                   generator_args={**base.generator_args, "n_resnet_blocks": 1, "init_channels_out": 4, "ndim": 2},
                   critic_args={**base.critic_args, "init_channels_out": 4, "discriminator_depth": 2, "ndim": 2},
                   do_elastic=False, do_scale=False, do_rotation=True, rotation_deg=360.0, p_rotation=0.5,
                   compute_dtype="float32", num_workers=(1, 1), log_every=1, validate_every=VALIDATE,
                   val_iterations=1, checkpoint_every=3, logger="file")
'''


def _cli_args(tmp_path, fold, run_id, validate="None"):
    conf, splits = tmp_path / f"tiny2d_{validate}.py", tmp_path / "splits.pkl"
    conf.write_text(OVERRIDE_2D.replace("VALIDATE", validate))
    splits.write_bytes(pickle.dumps({"train": [fold], "test": [fold]}))
    return ["--conf", str(conf), "--cval-splits", str(splits), "--checkpoint-root", str(tmp_path / "runs"),
            "--run-id", run_id, "--device", "cpu"]


def test_conf_2d_cli_fit_matches_jax_fit(fold_2d, tmp_path):
    """``main`` on a tiny ``conf_2d`` override (host augmentation through
    the native 2D warp, weight clip, f32) for 6 iterations, against the JAX
    package's ``Trainer.fit`` from the port's initial weights on the JAX
    loaders of the same seeds: every logged loss within 1e-3."""
    args = _cli_args(tmp_path, fold_2d, "cli")
    manager = train_cli.main([*args, "--iterations", "6"])
    trainer = manager.runs[0].trainer
    assert trainer.iteration == 6 and isinstance(trainer.logger_interface.inner, FileLogger2D)
    assert isinstance(manager.runs[0].train_loaders[0].sampler.augmenter, HostAugmenter2D)
    lines = (tmp_path / "runs" / "cli" / "metrics" / "scalars.jsonl").read_text().splitlines()
    got = [r for r in map(json.loads, lines) if r["stage"] == "train"]

    jcfg = dataclasses.replace(jax_config.load_config(args[1]), train_iterations=6)
    jbuilt = jax_builder.build(jcfg)
    assert isinstance(jbuilt.host_augmenter, JaxHostAugmenter2D)
    pbuilt = build(load_config(args[1]), device="cpu")  # the CLI's initial weights
    gvars = generator_variables_from_torch(generator_state_dict_to_reference(pbuilt.generator.state_dict()))
    cvars = critic_variables_from_torch(critic_state_dict_to_reference(pbuilt.critic.state_dict()))
    as_j = lambda t: jax.tree.map(jnp.asarray, t)
    state = jax_steps.GANTrainState(
        step=jnp.zeros((), jnp.int32), gen_params=as_j(gvars["params"]), gen_stats=as_j(gvars["batch_stats"]),
        critic_params=as_j(cvars["params"]), critic_stats=as_j(cvars["batch_stats"]),
        gen_opt=jbuilt.gen_tx.init(as_j(gvars["params"])), critic_opt=jbuilt.critic_tx.init(as_j(cvars["params"])),
        rng=jax.random.key(0))
    jlog = RecordingLogger(logs_images=False)
    tc = dataclasses.replace(jbuilt.trainer_config, checkpoint_dir=None, val_every=None, cycle_length=1,
                             log_images_every=None)
    jt = jax_trainer.Trainer(jbuilt.generator, jbuilt.critic, jbuilt.gen_tx, jbuilt.critic_tx, jbuilt.step_config,
                             tc, jax.random.key(0), jcfg.train_patch_size, logger_interface=jlog, state=state,
                             auto_resume=False)
    loaders = jax_pipeline.create_loaders(fold_2d, jcfg.train_patch_size, jcfg.train_batch_size,
                                          np.random.default_rng(jbuilt.seed), num_threads=1, prefetch=2,
                                          augmenter=jbuilt.host_augmenter, to_device=False, p_centerline_3d=0.0)
    try:
        jt.fit(loaders)
    finally:
        for loader in loaders.values():
            loader.stop()
    want = [s for s in jlog.scalars if s[0] == "train"]
    assert [r["iteration"] for r in got] == [s[1] for s in want] == list(range(6))
    for rec, (_, it, w) in zip(got, want):
        keys = {k for k in w if not k.startswith("tb/") and k != "patches_per_sec"}
        assert keys and keys <= set(rec)
        for k in keys:
            np.testing.assert_allclose(rec[k], w[k], rtol=1e-3, atol=1e-5, err_msg=f"iteration {it} {k}")


def test_conf_2d_cli_resume_equals_an_uninterrupted_run(fold_2d, tmp_path):
    """4 iterations, then a resume to 7 (validation every 2 at 32^2, a
    checkpoint every 3), against one run of 7: the same model, optimizers,
    generator state and data streams."""
    resumed = _cli_args(tmp_path, fold_2d, "resumed", validate="2")
    train_cli.main([*resumed, "--iterations", "4"])
    a = train_cli.main([*resumed, "--iterations", "7"]).runs[0].trainer
    assert a.start_iteration == 4
    b = train_cli.main([*_cli_args(tmp_path, fold_2d, "straight", validate="2"), "--iterations", "7"]).runs[0].trainer
    for net in ("generator", "critic"):
        sa, sb = getattr(a.state, net).state_dict(), getattr(b.state, net).state_dict()
        for k in sa:
            torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0, msg=f"{net}.{k}")
    for oa, ob in ((a.state.gen_opt, b.state.gen_opt), (a.state.critic_opt, b.state.critic_opt)):
        for pa, pb in zip(oa.optimizer.state.values(), ob.optimizer.state.values()):
            for k in pa:
                torch.testing.assert_close(pa[k], pb[k], rtol=0, atol=0)
    assert torch.equal(a.state.rng.get_state(), b.state.rng.get_state()) and a.iteration == b.iteration == 7
    lines = (tmp_path / "runs" / "resumed" / "metrics" / "scalars.jsonl").read_text()
    assert '"stage": "validation"' in lines
