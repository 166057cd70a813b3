"""The port's packed generator layout against the JAX package's, on the
CPU: forward, train-mode statistics and gradients in both transpose-conv
placements, f32 and bf16, against JAX's packed generator and against the
port's own direct layout with the same weights; ``packed_input`` /
``packed_output``; the guards; and ``D2STConv``. Mirrors the generator
tests of ``tests/test_packed.py``.

Tolerances: f32 forwards within 1e-4 of max|JAX|; gradients and
statistics within 1e-3 of max|JAX| per tensor; port packed against port
direct within 2e-4 absolute, the JAX package's own bound between its two
layouts; bf16 by the rule of ``tests/test_torch_port_bf16.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrast_gan_3d_tpu.models.blocks import ConvBlock as JaxConvBlock
from contrast_gan_3d_tpu.models.generator import ResnetGenerator as JaxGenerator
from contrast_gan_3d_tpu.ops import s2d_conv as jax_s2d
from contrast_gan_3d_tpu_torch.models.blocks import ConvBlock, D2STConv
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.ops import s2d_conv as port_s2d
from contrast_gan_3d_tpu_torch.utils.weights import generator_state_dict_from_jax
from tests.test_torch_port_bf16 import _ncdhw, _ndhwc, _stats, assert_bf16_rule, assert_rule_per_tensor, \
    carried, jax_runs
from tests.test_torch_port_models import TINY, _np_tree, carried_generator
from tests.test_torch_port_packed import _close, _t

GRAD_TOL = 1e-3
LAYOUT_TOL = 2e-4


def _x(seed, b=2):
    return np.random.default_rng(seed).normal(0, 0.5, (b, 16, 16, 16, 1)).astype(np.float32)


@pytest.mark.parametrize("placement", ["same", "torch"])
def test_packed_generator_forward_matches_jax_and_direct(placement):
    """Eval mode: port packed against JAX packed (1e-4 of max) and against
    the port's direct layout with the same weights (2e-4 absolute)."""
    jgen, variables, tgen = carried_generator(TINY, 3, tconv_placement=placement)
    x = _x(0)
    want = np.asarray(JaxGenerator(**TINY, tconv_placement=placement, layout="packed").apply(
        variables, jnp.asarray(x), train=False))
    tgen.eval()
    with torch.no_grad():
        got = _ndhwc(tgen.forward_packed(_ncdhw(x)))
        direct = _ndhwc(tgen(_ncdhw(x)))
    _close(got, want)
    assert np.abs(got.numpy() - direct.numpy()).max() <= LAYOUT_TOL
    # a generator built packed holds the same state_dict and gives the same
    packed_gen = ResnetGenerator(**TINY, tconv_placement=placement, layout="packed")
    packed_gen.load_state_dict(generator_state_dict_from_jax(variables), strict=True)
    assert packed_gen.state_dict().keys() == tgen.state_dict().keys()
    with torch.no_grad():
        assert torch.equal(_ndhwc(packed_gen.eval()(_ncdhw(x))), got)


def _train_run(gen, x, r, packed_layout):
    gen.train()
    fwd = gen.forward_packed if packed_layout else gen
    out = fwd(_ncdhw(x))
    names, params = zip(*gen.named_parameters())
    grads = torch.autograd.grad((out * _ncdhw(r)).sum(), params)
    return _ndhwc(out), dict(zip(names, grads)), _stats(gen.state_dict())


TWO_UP = dict(n_resnet_blocks=1, n_updownsample_blocks=2, init_channels_out=4)


@pytest.mark.parametrize("placement,cfg", [("same", TINY), ("torch", TINY), ("torch", TWO_UP)],
                         ids=["same", "torch", "torch-two-upsamples"])
def test_packed_generator_train_mode_matches_jax_and_direct(placement, cfg):
    """Train mode: the output, every parameter's gradient of sum(out * r)
    and the updated running statistics, port packed against JAX packed
    (1e-3 of max|JAX| per tensor) and against the port's direct layout
    (the same count n in the unbiased running variance); with two
    upsamples, the inner one a packed forward conv in the port and a
    transpose conv in JAX."""
    jgen, variables, tgen = carried_generator(cfg, 5, tconv_placement=placement)
    x, r = _x(1), np.random.default_rng(2).normal(size=(2, 16, 16, 16, 1)).astype(np.float32)
    jp = JaxGenerator(**cfg, tconv_placement=placement, layout="packed")

    def f(params):
        out, upd = jp.apply({"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x),
                            train=True, mutable=["batch_stats"])
        return jnp.sum(out * r), (out, upd["batch_stats"])

    (_, (j_out, j_stats)), j_grads = jax.value_and_grad(f, has_aux=True)(jax.tree.map(jnp.asarray,
                                                                                      variables["params"]))
    j_sd = generator_state_dict_from_jax({"params": _np_tree(j_grads), "batch_stats": _np_tree(j_stats)})
    direct = carried_generator(cfg, 5, tconv_placement=placement)[2]
    out, grads, stats = _train_run(tgen, x, r, True)
    d_out, d_grads, d_stats = _train_run(direct, x, r, False)
    _close(out, j_out)
    assert np.abs(out.numpy() - d_out.numpy()).max() <= LAYOUT_TOL
    for name, g in grads.items():
        _close(g, j_sd[name].numpy(), GRAD_TOL, name)
        _close(g, d_grads[name].numpy(), GRAD_TOL, name)
    for name, s in stats.items():
        _close(s, j_sd[name].numpy(), GRAD_TOL, name)
        _close(s, d_stats[name].numpy(), GRAD_TOL, name)


@pytest.mark.parametrize("train", [True, False])
def test_packed_generator_bf16_matches_jax(train):
    """The packed generator in bf16 against JAX's packed generator in f32
    and in its two bf16 compilations, by the bf16 rule: the attenuation, and
    in train mode every gradient and the running statistics."""
    cfg = dict(TINY, layout="packed")
    carry = generator_state_dict_from_jax
    variables, make, gen = carried(JaxGenerator, ResnetGenerator, cfg, (1, 16, 16, 16, 1), carry, 3)
    x, r = _x(4), np.random.default_rng(6).normal(size=(2, 16, 16, 16, 1)).astype(np.float32)

    def run(dtype, jit, _):
        module = make(dtype)

        def f(params):
            out = module.apply({"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x),
                               train=train, mutable=["batch_stats"] if train else False)
            out, upd = out if train else (out, {"batch_stats": variables["batch_stats"]})
            return jnp.sum(out.astype(jnp.float32) * r), (out, upd["batch_stats"])

        (_, (out, stats)), grads = jit(jax.value_and_grad(f, has_aux=True))(
            jax.tree.map(jnp.asarray, variables["params"]))
        return out, _stats(carry({"params": variables["params"], "batch_stats": _np_tree(stats)})), \
            carry({"params": _np_tree(grads)})

    (o32, s32, g32), j16s = jax_runs(run)
    gen.train(train)
    out = gen(_ncdhw(x))
    assert out.dtype == torch.bfloat16
    assert_bf16_rule(_ndhwc(out), [j[0] for j in j16s], o32, "attenuation")
    if not train:
        return
    names, params = zip(*gen.named_parameters())
    grads = torch.autograd.grad((out.float() * _ncdhw(r)).sum(), params)
    assert_rule_per_tensor(dict(zip(names, grads)), [j[2] for j in j16s], g32, "grad")
    assert_rule_per_tensor(_stats(gen.state_dict()), [j[1] for j in j16s], s32, "")


def test_packed_input_output_round_trip():
    """``packed_input`` takes an f2-packed patch and ``packed_output`` gives
    the f4 attenuation; unpacked, both equal the full-resolution forward."""
    jgen, variables, tgen = carried_generator(TINY, 7)
    x = _x(3)
    xt = port_s2d.space_to_depth(_t(x), 2)
    gen = ResnetGenerator(**TINY, layout="packed", packed_input=True, packed_output=True)
    gen.load_state_dict(tgen.state_dict(), strict=True)
    gen.eval(), tgen.eval()
    with torch.no_grad():
        got = gen(xt)
        assert tuple(got.shape) == (2, 4, 4, 4, 64)
        assert torch.equal(got, tgen.forward_packed(xt, packed_input=True, packed_output=True))
        full = _ndhwc(tgen(_ncdhw(x)))
    want = JaxGenerator(**TINY, layout="packed", packed_input=True, packed_output=True).apply(
        variables, jax_s2d.space_to_depth(jnp.asarray(x), 2), train=False)
    _close(got, want)
    assert np.abs(port_s2d.depth_to_space(got, 4).numpy() - full.numpy()).max() <= LAYOUT_TOL


@pytest.mark.parametrize("kw,match", [
    (dict(ndim=2), "3D-only"), (dict(norm="layer"), "norm='batch'"), (dict(norm=None), "norm='batch'"),
    (dict(n_updownsample_blocks=0), "n_updownsample_blocks >= 1"),
])
def test_packed_generator_guards(kw, match):
    """The JAX guards: building packed raises, and so does the packed
    forward of a direct generator that fails them."""
    cfg = dict(TINY, **kw)
    with pytest.raises(ValueError, match=match):
        ResnetGenerator(**cfg, layout="packed")
    gen = ResnetGenerator(**cfg)
    with pytest.raises(ValueError, match=match):
        gen.forward_packed(torch.zeros((1, 1) + (16,) * gen.ndim))


def test_packed_generator_refuses_unaligned_dims():
    gen = ResnetGenerator(**TINY, layout="packed").eval()
    with pytest.raises(ValueError, match="must divide 4"):
        gen(torch.zeros(1, 1, 16, 16, 18))
    with pytest.raises(ValueError, match="packed_input / packed_output need"):
        ResnetGenerator(**TINY, packed_output=True)


@pytest.mark.parametrize("placement", ["same", "torch"])
def test_d2s_conv_block_matches_jax(placement):
    """``ConvBlock(transpose=True, s2d=...)`` takes ``D2STConv`` with the
    parameters of ``nn.ConvTranspose3d``, as the JAX block takes its
    ``D2STConv``: forward, running statistics and gradients."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 6, 6, 6, 4)).astype(np.float32)
    jblock = JaxConvBlock(5, 3, stride=2, transpose=True, s2d=4, tconv_placement=placement)
    variables = _np_tree(jblock.init(jax.random.key(0), jnp.asarray(x), train=False))
    block = ConvBlock(4, 5, 3, stride=2, transpose=True, s2d=4, tconv_placement=placement)
    assert isinstance(block.conv, D2STConv) and block.conv.weight.shape == (4, 5, 3, 3, 3)
    block.load_state_dict(generator_state_dict_from_jax(variables), strict=True)

    def f(params):
        out, upd = jblock.apply({"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x),
                                train=True, mutable=["batch_stats"])
        return jnp.sum(out**2), (out, upd)

    (_, (want, upd)), j_grads = jax.value_and_grad(f, has_aux=True)(jax.tree.map(jnp.asarray, variables["params"]))
    out = block.train()(_ncdhw(x))
    _close(_ndhwc(out), want)
    names, params = zip(*block.named_parameters())
    grads = dict(zip(names, torch.autograd.grad((out**2).sum(), params)))
    j_sd = generator_state_dict_from_jax({"params": _np_tree(j_grads), "batch_stats": _np_tree(upd["batch_stats"])})
    for name, g in grads.items():
        _close(g, j_sd[name].numpy(), GRAD_TOL, name)
    _close(block.norm.running_var, j_sd["norm.running_var"].numpy(), GRAD_TOL)
