"""The port's bf16 compute (the JAX package's default dtype) vs the JAX
package, on the CPU: B3 (the s2d block conv) forward and backward,
BatchNorm, a transpose-conv ConvBlock, the generator, the critic, the
losses, the gradient penalty, one weight-clip and one gradient-penalty
``combined_step``, the validation steps, and a bf16 volume correction.

Sizes are tiny: generator ``n_resnet_blocks=1, init_channels_out=4`` (two
up/down blocks, s2d f=4) on 16^3 patches, critic ``init_channels_out=4,
discriminator_depth=2`` on 32^3 (16^3 inside the train step), batch 2 + 1
+ 1. Inputs are made with numpy from a seed; the weights are carried from
JAX (``utils/weights.py``) into port modules built with
``dtype=torch.bfloat16``.

Tolerance. bf16 keeps 8 significant bits, so the yardstick is how far the
JAX package's own bf16 results lie from its f32 one. J32 is the JAX f32
result and P16 the port's bf16 result. The JAX bf16 result is taken under
both of XLA's compilations: J16s with ``xla_allow_excess_precision`` off,
where XLA rounds to bf16 at every point the JAX program names (the
rounding points the port copies), and J16d with XLA's default, where the
compiler may keep fused bf16 intermediates in f32. The two differ from each
other about as much as either differs from f32 (up to 5.5x J16s's own
error on a gradient-penalty step's gradient tensor), so the yardstick is
the larger, and never less than 2^-8 max|J32|, about one bf16 ulp of the
largest value (a JAX run can land within its last bit by luck, as the
critic's mean logit over two samples does in the val step):
    ref = max(max|J16s - J32|, max|J16d - J32|, 2^-8 max|J32|).
Per output or per gradient tensor:
    max|P16 - J32| <= 2 * ref   and   max|P16 - J16s| <= 3 * ref,
and max|J16 - J32| > 0 is asserted, so the bound never rests on the floor
alone where JAX's bf16 equals its f32; a gradient that is exactly 0 in
every JAX run (a bias that d critic / d x does not see) must be exactly 0
in the port. Adam-updated parameters are held within
2 lr of every JAX run: Adam's first step is about lr * sign(g).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from contrast_gan_3d_tpu.eval.corrector import CCTAContrastCorrector as JaxCorrector
from contrast_gan_3d_tpu.models import losses as jax_losses
from contrast_gan_3d_tpu.models.blocks import ConvBlock as JaxConvBlock
from contrast_gan_3d_tpu.models.discriminator import PatchGANDiscriminator as JaxCritic
from contrast_gan_3d_tpu.models.generator import ResnetGenerator as JaxGenerator
from contrast_gan_3d_tpu.models.norm import BatchNorm as JaxBatchNorm
from contrast_gan_3d_tpu.ops import s2d_conv as jax_s2d
from contrast_gan_3d_tpu.ops.pallas_conv import s2d_conv3d_pallas
from contrast_gan_3d_tpu.trainer import optim as jax_optim
from contrast_gan_3d_tpu.trainer import steps as jax_steps
from contrast_gan_3d_tpu_torch.data.scaler import FactorZeroCenterScaler
from contrast_gan_3d_tpu_torch.eval.corrector import CCTAContrastCorrector
from contrast_gan_3d_tpu_torch.models import losses
from contrast_gan_3d_tpu_torch.models.blocks import ConvBlock
from contrast_gan_3d_tpu_torch.models.discriminator import PatchGANDiscriminator
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.models.norm import BatchNorm, frozen_batch_stats
from contrast_gan_3d_tpu_torch.ops import s2d_conv as port_s2d
from contrast_gan_3d_tpu_torch.ops.block_conv import s2d_conv3d_block
from contrast_gan_3d_tpu_torch.trainer import optim
from contrast_gan_3d_tpu_torch.trainer.steps import StepConfig, build_train_steps, build_val_steps, init_state
from contrast_gan_3d_tpu_torch.utils.weights import critic_state_dict_from_jax, generator_state_dict_from_jax
from tests.test_torch_port_models import _np_tree, randomize_norms

GEN = dict(n_resnet_blocks=1, init_channels_out=4)
CRITIC = dict(init_channels_out=4, discriminator_depth=2)
PATCH, CRITIC_PATCH = (16, 16, 16), (32, 32, 32)
B_OPT, B_LOW, B_HIGH = 2, 1, 1
GP_EPS = 0.3
MODES = {
    "wc": dict(norm="batch", lr=2e-4, betas=(0.5, 0.999), weight_clip=0.01),
    "gp": dict(norm=None, lr=1e-4, betas=(0.0, 0.9), weight_clip=None),
}
# XLA rounds to bf16 at every point the JAX program names (J16s)
STRICT = {"xla_allow_excess_precision": False}
strict_jit = partial(jax.jit, compiler_options=STRICT)


def jax_runs(run):
    """``run(dtype, jit, options)`` -> (J32, (J16s, J16d)); ``jit`` compiles a
    function and ``options`` are the compiler options of the JAX package's
    own jitted entry points (None: XLA's default)."""
    return run(jnp.float32, jax.jit, None), (run(jnp.bfloat16, strict_jit, STRICT), run(jnp.bfloat16, jax.jit, None))


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32), np.float64)


def assert_bf16_rule(p16, j16s, j32, what):
    """The module docstring's rule on one tensor (or scalar); ``j16s`` is
    (J16s, J16d)."""
    p16, j32 = _f64(p16), _f64(j32)
    j16s = [_f64(j) for j in j16s]
    assert all(p16.shape == j.shape == j32.shape for j in j16s), (what, p16.shape, j32.shape)
    ref = max(np.abs(j - j32).max() for j in j16s)
    if ref == 0 and not j32.any():
        assert not p16.any(), f"{what}: exactly 0 in every JAX run, not in the port"
        return
    assert ref > 0, f"{what}: JAX bf16 equals JAX f32, the bound would be vacuous"
    ref = max(ref, 2.0**-8 * np.abs(j32).max())
    e32, e16 = np.abs(p16 - j32).max(), np.abs(p16 - j16s[0]).max()
    assert e32 <= 2 * ref and e16 <= 3 * ref, (
        f"{what}: max|P16-J32| {e32:.3e} (<= {2 * ref:.3e}), max|P16-J16s| {e16:.3e} (<= {3 * ref:.3e})"
    )


def assert_rule_per_tensor(p16: dict, j16s, j32: dict, what):
    """The rule per entry of dicts of tensors (``j16s``: two dicts)."""
    assert all(set(p16) == set(j) == set(j32) for j in j16s), what
    for k in p16:
        assert_bf16_rule(p16[k], [j[k] for j in j16s], j32[k], f"{what} {k}")


def _ncdhw(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).permute(0, 4, 1, 2, 3).to(dtype)


def _ndhwc(t):
    return t.detach().permute(0, 2, 3, 4, 1)


def _jnp(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _grad_sd(grads, carry):
    """A JAX gradient tree -> the port's parameter names (same layouts as
    the weights)."""
    return carry({"params": _np_tree(grads)})


# --- B3 ---------------------------------------------------------------------


@pytest.mark.parametrize("fn", [s2d_conv3d_block, port_s2d.s2d_conv3d], ids=["b3", "plain"])
@pytest.mark.parametrize(
    "x_shape,ci,co,bias",
    [((2, 16, 16, 16, 1), 1, 4, False),   # the tiny generator's stem
     ((2, 16, 16, 16, 4), 4, 1, True),    # its projection, with the bias
     ((1, 8, 12, 16, 2), 2, 3, True)],    # non-cubic
)
def test_s2d_conv_bf16_forward_and_backward_match_jax(rng, fn, x_shape, ci, co, bias):
    """B3 (``s2d_conv3d_block``, B1's plain version on the CPU) and the plain
    ``s2d_conv3d`` on bf16 x, w and bias against JAX ``s2d_conv3d``: the
    output, and x's, w's and the bias's gradients for a random cotangent.
    The forward is also held against the Pallas B3 (interpret mode) in
    bf16 under the same rule."""
    x = rng.normal(size=x_shape).astype(np.float32)
    w = (rng.normal(size=(7, 7, 7, ci, co)) / np.sqrt(343 * ci)).astype(np.float32)
    b = rng.normal(size=(co,)).astype(np.float32) if bias else None
    r = rng.normal(size=x_shape[:4] + (co,)).astype(np.float32)
    args = (x, w) + ((b,) if bias else ())

    def run(dtype, jit, _):
        def f(*a):
            return jax_s2d.s2d_conv3d(a[0], a[1], a[2] if bias else None, f=4, padding_mode="reflect")

        @jit
        def vjp_run(*prim):
            out, vjp = jax.vjp(f, *prim)
            return out, vjp(_jnp(r, out.dtype))

        return vjp_run(*[_jnp(a, dtype) for a in args])

    (j32, g32), j16s = jax_runs(run)
    assert j16s[0][0].dtype == jnp.bfloat16
    prims = [torch.from_numpy(a).bfloat16().requires_grad_(True) for a in args]
    out = fn(prims[0], prims[1], prims[2] if bias else None, f=4, padding_mode="reflect")
    assert out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out, prims, torch.from_numpy(r).bfloat16())
    assert_bf16_rule(out, [j[0] for j in j16s], j32, "output")
    for i, (name, g) in enumerate(zip(("dx", "dw", "dbias"), grads)):
        assert g.dtype == torch.bfloat16
        assert_bf16_rule(g, [j[1][i] for j in j16s], g32[i], name)
    with pltpu.force_tpu_interpret_mode():
        pallas16 = [jit(partial(s2d_conv3d_pallas, f=4, padding_mode="reflect"))(
            *[_jnp(a, jnp.bfloat16) for a in (x, w)], _jnp(b, jnp.bfloat16) if bias else None)
            for jit in (strict_jit, jax.jit)]
    assert_bf16_rule(out, pallas16, j32, "output vs Pallas B3")


# --- modules ----------------------------------------------------------------


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_bf16_matches_jax(rng, train):
    """bf16 in, bf16 out, f32 statistics and running EMA."""
    x = rng.normal(1.0, 2.0, (2, 4, 5, 6, 3)).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, 3).astype(np.float32), "bias": rng.normal(size=3).astype(np.float32)}
    stats = {"mean": rng.normal(size=3).astype(np.float32), "var": rng.uniform(0.5, 2.0, 3).astype(np.float32)}

    def run(dtype, jit, _):
        bn = JaxBatchNorm(use_running_average=not train, momentum=0.9, epsilon=1e-5, dtype=dtype)
        out, upd = jit(partial(bn.apply, mutable=["batch_stats"]))(
            {"params": params, "batch_stats": stats}, _jnp(x, dtype))
        return out, upd["batch_stats"]

    (j32, s32), j16s = jax_runs(run)
    bn = BatchNorm(3, dtype=torch.bfloat16)
    bn.load_state_dict({"weight": torch.from_numpy(params["scale"]), "bias": torch.from_numpy(params["bias"]),
                        "running_mean": torch.from_numpy(stats["mean"]),
                        "running_var": torch.from_numpy(stats["var"])})
    bn.train(train)
    got = bn(_ncdhw(x, torch.bfloat16))
    assert got.dtype == torch.bfloat16 and bn.running_var.dtype == torch.float32
    assert_bf16_rule(_ndhwc(got), [j[0] for j in j16s], j32, "output")
    if train:
        assert_bf16_rule(bn.running_mean, [j[1]["mean"] for j in j16s], s32["mean"], "running_mean")
        assert_bf16_rule(bn.running_var, [j[1]["var"] for j in j16s], s32["var"], "running_var")


def test_transpose_conv_block_bf16_matches_jax(rng):
    """A stride-2 transpose ConvBlock (the generator's ``up_*``: "same"
    window, BatchNorm in train mode, relu): output, running statistics and
    the input's and every parameter's gradient."""
    x = rng.normal(0, 1, (2, 6, 5, 4, 4)).astype(np.float32)
    r = rng.normal(size=(2, 12, 10, 8, 3)).astype(np.float32)
    kw = dict(stride=2, transpose=True, norm="batch", activation="relu", tconv_placement="same")
    variables = JaxConvBlock(3, 3, **kw).init(jax.random.key(0), jnp.zeros(x.shape), train=False)
    variables = randomize_norms(_np_tree(variables), np.random.default_rng(1))
    carry = generator_state_dict_from_jax

    def run(dtype, jit, _):
        block = JaxConvBlock(3, 3, dtype=dtype, **kw)

        def f(params, xin):
            out, upd = block.apply({"params": params, "batch_stats": variables["batch_stats"]}, xin,
                                   train=True, mutable=["batch_stats"])
            return out, upd["batch_stats"]

        @jit
        def vjp_run(params, xin):
            out, vjp, stats = jax.vjp(f, params, xin, has_aux=True)
            return (out, stats) + vjp(_jnp(r, out.dtype))

        out, stats, gp, gx = vjp_run(jax.tree.map(jnp.asarray, variables["params"]), _jnp(x, dtype))
        return out, carry({"params": variables["params"], "batch_stats": _np_tree(stats)}), _grad_sd(gp, carry), gx

    (o32, s32, gp32, gx32), j16s = jax_runs(run)
    block = ConvBlock(4, 3, 3, dtype=torch.bfloat16, **kw)
    block.load_state_dict(carry(variables), strict=True)
    xt = _ncdhw(x, torch.bfloat16).requires_grad_(True)
    out = block(xt)
    assert out.dtype == torch.bfloat16
    names, params = zip(*block.named_parameters())
    grads = torch.autograd.grad(out, (xt,) + params, _ncdhw(r, torch.bfloat16))
    assert_bf16_rule(_ndhwc(out), [j[0] for j in j16s], o32, "output")
    assert_bf16_rule(_ndhwc(grads[0]), [j[3] for j in j16s], gx32, "dx")
    assert_rule_per_tensor(dict(zip(names, grads[1:])), [j[2] for j in j16s], gp32, "grad")
    for k in ("norm.running_mean", "norm.running_var"):
        assert_bf16_rule(block.state_dict()[k], [j[1][k] for j in j16s], s32[k], k)


def carried(jax_cls, port_cls, cfg, shape, carry, seed):
    """One set of numpy variables for ``jax_cls(**cfg)`` (parameters are f32
    in both frameworks whatever the compute dtype), ``make(dtype)`` for the
    JAX module in a dtype, and the port module built with
    ``dtype=torch.bfloat16`` holding the variables."""
    variables = jax_cls(**cfg).init(jax.random.key(seed), jnp.zeros(shape), train=False)
    variables = randomize_norms(_np_tree(variables), np.random.default_rng(seed))
    p16 = port_cls(**cfg, dtype=torch.bfloat16)
    p16.load_state_dict(carry(variables), strict=True)
    return variables, lambda dtype: jax_cls(**cfg, dtype=dtype), p16


def _stats(sd):
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


@pytest.mark.parametrize("train", [True, False])
def test_generator_bf16_matches_jax(train):
    """The tiny generator in bf16, both BatchNorm modes: the attenuation
    (bf16), and in train mode the running statistics and every parameter's
    gradient of sum(out * r), through B3's bf16 backward."""
    carry = generator_state_dict_from_jax
    variables, make, gen = carried(JaxGenerator, ResnetGenerator, GEN, (1, *PATCH, 1), carry, 3)
    rng = np.random.default_rng(4)
    x = rng.normal(0, 0.5, (2, *PATCH, 1)).astype(np.float32)
    r = rng.normal(size=(2, *PATCH, 1)).astype(np.float32)

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
            _grad_sd(grads, carry)

    (o32, s32, g32), j16s = jax_runs(run)
    assert j16s[0][0].dtype == jnp.bfloat16
    gen.train(train)
    out = gen(_ncdhw(x))  # the f32 input is cast by the first block
    assert out.dtype == torch.bfloat16
    assert_bf16_rule(_ndhwc(out), [j[0] for j in j16s], o32, "attenuation")
    if not train:
        return
    names, params = zip(*gen.named_parameters())
    grads = torch.autograd.grad((out.float() * _ncdhw(r)).sum(), params)
    assert_rule_per_tensor(dict(zip(names, grads)), [j[2] for j in j16s], g32, "grad")
    assert_rule_per_tensor(_stats(gen.state_dict()), [j[1] for j in j16s], s32, "")


@pytest.mark.parametrize("train", [True, False])
def test_critic_bf16_matches_jax(train):
    carry = critic_state_dict_from_jax
    variables, make, critic = carried(JaxCritic, PatchGANDiscriminator, CRITIC, (1, *CRITIC_PATCH, 1), carry, 5)
    x = np.random.default_rng(6).normal(0, 0.5, (2, *CRITIC_PATCH, 1)).astype(np.float32)

    def run(dtype, jit, _):
        apply = partial(make(dtype).apply, train=train, mutable=["batch_stats"] if train else False)
        out = jit(apply)(variables, _jnp(x, dtype))
        out, upd = out if train else (out, {"batch_stats": variables["batch_stats"]})
        return out, _stats(carry({"params": variables["params"], "batch_stats": _np_tree(upd["batch_stats"])}))

    (o32, s32), j16s = jax_runs(run)
    critic.train(train)
    with torch.no_grad():
        out = critic(_ncdhw(x, torch.bfloat16))
    assert out.dtype == torch.bfloat16
    assert_bf16_rule(_ndhwc(out), [j[0] for j in j16s], o32, "logits")
    if train:
        assert_rule_per_tensor(_stats(critic.state_dict()), [j[1] for j in j16s], s32, "")


# --- losses -----------------------------------------------------------------


def _loss_case(jax_fn, port_fn, arrays, what):
    """Value and gradients with respect to every array, bf16 against JAX."""
    def run(dtype, jit, _):
        return jit(jax.value_and_grad(jax_fn, argnums=tuple(range(len(arrays)))))(*[_jnp(a, dtype) for a in arrays])

    (v32, g32), j16s = jax_runs(run)
    ts = [torch.from_numpy(np.asarray(a, np.float32)).bfloat16().requires_grad_(True) for a in arrays]
    val = port_fn(*ts)
    grads = torch.autograd.grad(val, ts)
    assert_bf16_rule(val, [j[0] for j in j16s], v32, f"{what} value")
    for i, g in enumerate(grads):
        assert g.dtype == torch.bfloat16
        assert_bf16_rule(g, [j[1][i] for j in j16s], g32[i], f"{what} grad {i}")
    return val


def test_wasserstein_loss_bf16_matches_jax(rng):
    # sizes that are not powers of two, so 1/n rounds in bf16
    f, r = rng.normal(size=(3, 1, 3, 5, 2)), rng.normal(size=(2, 1, 3, 5, 3))
    val = _loss_case(jax_losses.wasserstein_loss, losses.wasserstein_loss, (f, r), "wasserstein")
    assert val.dtype == torch.bfloat16


def test_zncc_loss_bf16_matches_jax(rng):
    s = rng.normal(size=(2, 1, 6, 5, 7))
    t = 0.6 * s + rng.normal(size=(2, 1, 6, 5, 7))
    val = _loss_case(jax_losses.zncc_loss, losses.zncc_loss, (s, t), "zncc")
    assert val.dtype == torch.bfloat16


def test_hu_loss_bf16_matches_jax(rng):
    """bf16 batch, f32 mask: the loss is f32 in both frameworks."""
    x = rng.normal(0.2, 0.3, (2, 1, 6, 5, 7)).astype(np.float32)
    m = (rng.random((2, 1, 6, 5, 7)) < 0.3).astype(np.float32)
    lo, hi = losses.scale_bounds(FactorZeroCenterScaler(), (350.0, 450.0))

    def run(dtype, jit, _):
        return jit(jax.value_and_grad(partial(jax_losses.hu_loss, min_hu=lo, max_hu=hi)))(
            _jnp(x, dtype), jnp.asarray(m))

    (v32, g32), j16s = jax_runs(run)
    xt = torch.from_numpy(x).bfloat16().requires_grad_(True)
    val = losses.hu_loss(xt, torch.from_numpy(m), lo, hi)
    assert val.dtype == torch.float32 and j16s[0][0].dtype == jnp.float32
    (g,) = torch.autograd.grad(val, xt)
    assert_bf16_rule(val, [j[0] for j in j16s], v32, "hu value")
    assert_bf16_rule(g, [j[1] for j in j16s], g32, "hu grad")


@pytest.mark.parametrize("norm", [None, "batch"])
def test_gradient_penalty_bf16_matches_jax(norm):
    """Fixed eps in bf16, a bf16 critic on bf16 real and fake: the penalty
    and every critic parameter's gradient through the double backward; a
    batch-norm critic runs in train mode with its statistics frozen."""
    carry = critic_state_dict_from_jax
    variables, make, critic = carried(JaxCritic, PatchGANDiscriminator, dict(CRITIC, norm=norm),
                                      (1, *CRITIC_PATCH, 1), carry, 7)
    rng = np.random.default_rng(8)
    real = rng.normal(0, 0.5, (2, *CRITIC_PATCH, 1)).astype(np.float32)
    fake = rng.normal(0, 0.5, (2, *CRITIC_PATCH, 1)).astype(np.float32)
    stats = variables.get("batch_stats", {})

    def run(dtype, jit, _):
        module = make(dtype)

        def gp(params):
            fn = lambda x: jax_steps._apply(module, params, stats, x, train=True)
            eps = jnp.full((2, 1, 1, 1, 1), GP_EPS, dtype)
            return jax_losses.gradient_penalty(fn, _jnp(real, dtype), _jnp(fake, dtype), jax.random.key(0), 10.0,
                                               eps=eps)

        val, grads = jit(jax.value_and_grad(gp))(jax.tree.map(jnp.asarray, variables["params"]))
        return val, _grad_sd(grads, carry)

    (v32, g32), j16s = jax_runs(run)
    assert j16s[0][0].dtype == jnp.bfloat16
    critic.train()
    eps = torch.full((2, 1, 1, 1, 1), GP_EPS, dtype=torch.bfloat16)
    with frozen_batch_stats(critic):
        val = losses.gradient_penalty(critic, _ncdhw(real, torch.bfloat16), _ncdhw(fake, torch.bfloat16),
                                      torch.Generator().manual_seed(0), 10.0, eps=eps)
    assert val.dtype == torch.bfloat16
    names, params = zip(*critic.named_parameters())
    # a parameter that d critic / d x does not see has no graph here
    grads = torch.autograd.grad(val, params, allow_unused=True)
    got = {n: torch.zeros_like(p) if g is None else g for n, p, g in zip(names, params, grads)}
    assert_bf16_rule(val, [j[0] for j in j16s], v32, "penalty")
    assert_rule_per_tensor(got, [j[1] for j in j16s], g32, "grad")


# --- the train step ---------------------------------------------------------


def _recording(tx):
    """``tx`` behind a transformation that keeps the last gradients in its
    state, so the JAX step's gradients can be read after it ran."""
    keep = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))
    return optax.chain(keep, tx)


def _batches(seed):
    rng = np.random.default_rng(seed)
    opt = rng.integers(-1024, 1500, (B_OPT, *PATCH)).astype(np.int16)
    sub = rng.integers(-1024, 1500, (B_LOW + B_HIGH, *PATCH)).astype(np.int16)
    msk = (rng.random((B_LOW + B_HIGH, *PATCH)) < 0.05).astype(np.int16)
    return opt, sub, msk


@pytest.mark.parametrize("mode", list(MODES))
def test_combined_step_bf16_matches_jax(mode):
    """One bf16 ``combined_step`` (critic update, then the generator's
    against the updated critic), weight clip or gradient penalty with a
    fixed eps: the losses, every gradient tensor of both networks, the
    BatchNorm running statistics, and the Adam-updated parameters."""
    m = MODES[mode]
    gvars, make_gen, gen = carried(JaxGenerator, ResnetGenerator, GEN, (1, *PATCH, 1),
                                   generator_state_dict_from_jax, 10)
    cvars, make_critic, critic = carried(JaxCritic, PatchGANDiscriminator, dict(CRITIC, norm=m["norm"]),
                                         (1, *PATCH, 1), critic_state_dict_from_jax, 11)
    opt, sub, msk = _batches(12)
    gp_eps = None if m["weight_clip"] else GP_EPS
    tx = _recording(jax_optim.make_optimizer(lr=m["lr"], betas=m["betas"]))
    as_j = lambda t: jax.tree.map(jnp.asarray, t)
    carries = {"generator": generator_state_dict_from_jax, "critic": critic_state_dict_from_jax}

    def run(dtype, _, options):
        cfg = jax_steps.StepConfig(weight_clip=m["weight_clip"], augment=None, dtype=dtype, gp_eps=gp_eps,
                                   compiler_options=options)
        state = jax_steps.GANTrainState(
            step=jnp.zeros((), jnp.int32),
            gen_params=as_j(gvars["params"]), gen_stats=as_j(gvars["batch_stats"]),
            critic_params=as_j(cvars["params"]), critic_stats=as_j(cvars.get("batch_stats", {})),
            gen_opt=tx.init(as_j(gvars["params"])), critic_opt=tx.init(as_j(cvars["params"])),
            rng=jax.random.key(0),
        )
        steps = jax_steps.build_train_steps(make_gen(dtype), make_critic(dtype), tx, tx, cfg)
        state, metrics = steps.combined_step(state, opt, sub, msk)
        trees = {"generator": (state.gen_params, state.gen_stats, state.gen_opt[0]),
                 "critic": (state.critic_params, state.critic_stats, state.critic_opt[0])}
        sd, grads = {}, {}
        for net, (params, stats, g) in trees.items():
            for k, v in carries[net]({"params": _np_tree(params), "batch_stats": _np_tree(stats)}).items():
                sd[f"{net}.{k}"] = v
            for k, v in _grad_sd(g, carries[net]).items():
                grads[f"{net}.{k}"] = v
        return {k: float(v) for k, v in metrics.items()}, grads, sd

    (m32, g32, s32), j16s = jax_runs(run)
    tx_port = partial(optim.make_optimizer, "adam", lr=m["lr"], betas=m["betas"])
    state = init_state(gen, critic, tx_port, tx_port, seed=0, device="cpu")
    cfg = StepConfig(weight_clip=m["weight_clip"], gp_eps=gp_eps, dtype=torch.bfloat16)
    state, metrics = build_train_steps(cfg).combined_step(state, opt, sub, msk)
    assert_rule_per_tensor({k: v.float() for k, v in metrics.items()}, [j[0] for j in j16s], m32, "metric")
    got = {f"{net}.{n}": p.grad for net in carries for n, p in getattr(state, net).named_parameters()}
    assert_rule_per_tensor(got, [j[1] for j in j16s], g32, "grad")
    for net in carries:
        for k, v in getattr(state, net).state_dict().items():
            k = f"{net}.{k}"
            if k.endswith(("running_mean", "running_var")):
                assert_bf16_rule(v, [j[2][k] for j in j16s], s32[k], k)
            else:
                for want in (s32[k], *(j[2][k] for j in j16s)):
                    diff = np.abs(_f64(v) - _f64(want)).max()
                    assert diff <= 2 * m["lr"] * (1 + 1e-3), (k, diff)


def test_val_steps_bf16_match_jax():
    """Eval-mode validation with bf16 networks, the last of 3 samples
    invalid: as in the JAX val steps the scaled batch stays f32 (the first
    block casts it), so the corrected batch is f32 and the attenuation
    bf16."""
    gvars, make_gen, gen = carried(JaxGenerator, ResnetGenerator, GEN, (1, *PATCH, 1),
                                   generator_state_dict_from_jax, 16)
    cvars, make_critic, critic = carried(JaxCritic, PatchGANDiscriminator, CRITIC, (1, *PATCH, 1),
                                         critic_state_dict_from_jax, 17)
    batch = np.random.default_rng(18).integers(-1024, 1500, (3, *PATCH)).astype(np.int16)
    w = np.array([1, 1, 0], np.float32)
    as_j = lambda t: jax.tree.map(jnp.asarray, t)

    def run(dtype, jit, _):
        state = jax_steps.GANTrainState(
            step=jnp.zeros((), jnp.int32), gen_params=as_j(gvars["params"]), gen_stats=as_j(gvars["batch_stats"]),
            critic_params=as_j(cvars["params"]), critic_stats=as_j(cvars["batch_stats"]),
            gen_opt=(), critic_opt=(), rng=jax.random.key(0))
        cfg = jax_steps.StepConfig(augment=None, dtype=dtype)
        vopt, vsub = jax_steps.build_val_steps(make_gen(dtype), make_critic(dtype), cfg)
        return (jit(vopt)(state, batch, w),) + tuple(jit(vsub)(state, batch, w))

    j32, j16s = jax_runs(run)
    tx = partial(optim.make_optimizer, "adam")
    state = init_state(gen, critic, tx, tx, device="cpu")
    vopt, vsub = build_val_steps(StepConfig(dtype=torch.bfloat16))
    got = (vopt(state, batch, w),) + tuple(vsub(state, batch, w))
    assert got[3].dtype == torch.float32 and got[4].dtype == torch.bfloat16
    assert j16s[0][3].dtype == jnp.float32 and j16s[0][4].dtype == jnp.bfloat16
    for i, name in enumerate(("realism opt", "realism fake", "zncc", "corrected", "attenuation")):
        p16 = got[i] if i < 3 else _ndhwc(got[i])
        assert_bf16_rule(p16, [j[i] for j in j16s], j32[i], name)


def test_bf16_modules_keep_f32_parameters_and_statistics():
    """bf16-built networks take f32 weights under strict=True and keep f32
    parameters, gradients, Adam moments and running statistics through a
    train step; only the activations are bf16."""
    gen = ResnetGenerator(**GEN, dtype=torch.bfloat16)
    gen.load_state_dict(ResnetGenerator(**GEN).state_dict(), strict=True)
    critic = PatchGANDiscriminator(**CRITIC, dtype=torch.bfloat16)
    tx = partial(optim.make_optimizer, "adam", lr=2e-4, betas=(0.5, 0.999))
    state = init_state(gen, critic, tx, tx, seed=0, device="cpu")
    opt, sub, msk = _batches(13)
    steps = build_train_steps(StepConfig(dtype=torch.bfloat16))
    state, metrics = steps.combined_step(state, opt, sub, msk)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    for net, sched in ((state.generator, state.gen_opt), (state.critic, state.critic_opt)):
        for name, t in list(net.named_parameters()) + list(net.named_buffers()):
            assert t.dtype == torch.float32, name
        for p in net.parameters():
            assert p.grad.dtype == torch.float32
            assert all(v.dtype == torch.float32 for v in sched.optimizer.state[p].values() if v.dim())
    with torch.no_grad():
        assert state.generator(torch.zeros((1, 1, *PATCH))).dtype == torch.bfloat16


# --- serving ----------------------------------------------------------------


def test_bf16_correction_matches_jax():
    """A (24, 24, 20) int16 volume, 16^3 patches at 25% overlap, batch 3,
    corrected by a bf16 generator through ``CCTAContrastCorrector(dtype=
    torch.bfloat16)`` against the JAX corrector with ``dtype=jnp.bfloat16``
    and a bf16 generator, in HU, in the direct layout."""
    _bf16_correction_matches_jax("direct")


def test_bf16_correction_matches_jax_default_layout():
    """The same in both packages' default layout, packed for this generator
    and window."""
    _bf16_correction_matches_jax("auto")


def _bf16_correction_matches_jax(layout):
    variables, make, gen = carried(JaxGenerator, ResnetGenerator, GEN, (1, *PATCH, 1),
                                   generator_state_dict_from_jax, 14)
    vol = np.random.default_rng(15).integers(-1024, 1500, (24, 24, 20)).astype(np.int16)
    kw = dict(inference_patch_size=PATCH, overlap=0.25, batch_size=3, layout=layout)

    def run(dtype, jit, _):
        corrector = JaxCorrector(make(dtype), variables["params"], variables["batch_stats"], dtype=dtype, **kw)
        return jit(corrector.correct_volume)(vol)

    j32, j16s = jax_runs(run)
    got = CCTAContrastCorrector(gen, device="cpu", dtype=torch.bfloat16, **kw)(vol)
    assert got.dtype == torch.float32 and tuple(got.shape) == vol.shape
    assert_bf16_rule(got, j16s, j32, "corrected HU")
