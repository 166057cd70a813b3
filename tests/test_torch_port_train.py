"""The port's training slice vs the JAX package, on the CPU: the PatchGAN
critic, the losses, the gradient penalty, the optimizers, the train and
validation steps, the schedule and a short trajectory.

Sizes are tiny: generator ``n_resnet_blocks=2, n_updownsample_blocks=1,
init_channels_out=8``, critic ``depth=2, init=4``, 16^3 patches, batch
2 + 1 + 1. Both sides get the same weights (carried from JAX with
``utils/weights.py``) and the same int16 batches, made with numpy.
Tolerances, and why:
- losses and metrics: 1e-5 absolute / 1e-4 relative (f32 sums in another
  order over a few thousand voxels);
- gradients: 1e-4 of the tensor's max|grad| (the same sums, then a
  backward through a few convolutions);
- BatchNorm running statistics: 1e-5 (one f32 EMA of batch moments);
- parameters after Adam updates: Adam's first step is lr * m/(sqrt(v)+eps),
  about lr * sign(g), so an element whose gradient is float noise may step
  the other way in the other framework: every element within 2 * lr (plus
  2e-6 per step for the ordinary f32 drift), and at least 99.9% of them
  within 2e-6 per step.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from contrast_gan_3d_tpu.models import losses as jax_losses
from contrast_gan_3d_tpu.models.discriminator import PatchGANDiscriminator as JaxCritic
from contrast_gan_3d_tpu.models.utils import count_parameters as jax_count
from contrast_gan_3d_tpu.trainer import optim as jax_optim
from contrast_gan_3d_tpu.trainer import steps as jax_steps
from contrast_gan_3d_tpu_torch.data.scaler import FactorZeroCenterScaler
from contrast_gan_3d_tpu_torch.models import losses
from contrast_gan_3d_tpu_torch.models.discriminator import PatchGANDiscriminator
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.models.norm import frozen_batch_stats
from contrast_gan_3d_tpu_torch.models.utils import count_parameters
from contrast_gan_3d_tpu_torch.trainer import optim
from contrast_gan_3d_tpu_torch.trainer.steps import (
    StepConfig,
    _masked_mean,
    _masked_zncc,
    build_train_steps,
    build_val_steps,
    init_state,
    schedule_branches,
)
from contrast_gan_3d_tpu_torch.trainer.trainer import HIGH, LOW, OPT, Trainer, TrainerConfig
from contrast_gan_3d_tpu_torch.utils.weights import critic_state_dict_from_jax, generator_state_dict_from_jax
from tests.test_torch_port_models import TINY, _np_tree, carried_generator, randomize_norms

CRITIC = dict(init_channels_out=4, discriminator_depth=2)
PATCH = (16, 16, 16)
B_OPT, B_LOW, B_HIGH = 2, 1, 1
# the presets: basic_3d (weight clip, batch-norm critic) and
# gradient_penalty (critic norm None, Adam 1e-4 (0, 0.9)); "gp-batch" is GP
# with a batch-norm critic, whose penalty must not touch the statistics
MODES = {
    "wc": dict(norm="batch", lr=2e-4, betas=(0.5, 0.999), weight_clip=0.01),
    "gp": dict(norm=None, lr=1e-4, betas=(0.0, 0.9), weight_clip=None),
    "gp-batch": dict(norm="batch", lr=1e-4, betas=(0.0, 0.9), weight_clip=None),
}
GP_EPS = 0.3


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def carried_critic(seed, norm="batch", **cfg):
    """(jax module, numpy variables, port module with the same weights)."""
    kw = {**CRITIC, **cfg, "norm": norm}
    jc = JaxCritic(**kw)
    variables = jc.init(jax.random.key(seed), jnp.zeros((1, *PATCH, 1)), train=False)
    variables = randomize_norms(_np_tree(variables), np.random.default_rng(seed))
    tc = PatchGANDiscriminator(**kw)
    tc.load_state_dict(critic_state_dict_from_jax(variables), strict=True)
    return jc, variables, tc


def batches(seed, n=1, mask_p=0.05):
    """``n`` iterations of int16 (opt, subopt, mask) batches, the mask a
    sparse centerline stand-in."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        opt = rng.integers(-1024, 1500, (B_OPT, *PATCH)).astype(np.int16)
        sub = rng.integers(-1024, 1500, (B_LOW + B_HIGH, *PATCH)).astype(np.int16)
        msk = (rng.random((B_LOW + B_HIGH, *PATCH)) < mask_p).astype(np.int16)
        out.append((opt, sub, msk))
    return out


class Pair:
    """The same initial train state on both sides, for one mode."""

    def __init__(self, mode, seed=0):
        m = MODES[mode]
        self.mode, self.lr = mode, m["lr"]
        self.jgen, gvars, tgen = carried_generator(TINY, seed)
        self.jcritic, cvars, tcritic = carried_critic(seed + 1, norm=m["norm"])
        tx = jax_optim.make_optimizer(lr=m["lr"], betas=m["betas"])
        self.jcfg = jax_steps.StepConfig(
            weight_clip=m["weight_clip"], augment=None, dtype=jnp.float32,
            gp_eps=None if m["weight_clip"] else GP_EPS,
        )
        self.tx = tx
        as_j = lambda t: jax.tree.map(jnp.asarray, t)
        self.jstate = jax_steps.GANTrainState(
            step=jnp.zeros((), jnp.int32),
            gen_params=as_j(gvars["params"]), gen_stats=as_j(gvars["batch_stats"]),
            critic_params=as_j(cvars["params"]), critic_stats=as_j(cvars.get("batch_stats", {})),
            gen_opt=tx.init(as_j(gvars["params"])), critic_opt=tx.init(as_j(cvars["params"])),
            rng=jax.random.key(seed),
        )
        self.cfg = StepConfig(weight_clip=m["weight_clip"], gp_eps=None if m["weight_clip"] else GP_EPS)
        opt_kw = dict(lr=m["lr"], betas=m["betas"])
        self.tx_port = partial(optim.make_optimizer, "adam", **opt_kw)
        self.tgen, self.tcritic = tgen, tcritic

    def port_state(self):
        return init_state(self.tgen, self.tcritic, self.tx_port, self.tx_port, seed=0, device="cpu")

    def check(self, state, steps_taken):
        """Port parameters and statistics against the JAX state."""
        j = self.jstate
        for module, params, stats, carry, what in (
            (state.generator, j.gen_params, j.gen_stats, generator_state_dict_from_jax, "generator"),
            (state.critic, j.critic_params, j.critic_stats, critic_state_dict_from_jax, "critic"),
        ):
            want = carry({"params": _np_tree(params), "batch_stats": _np_tree(stats)})
            got = module.state_dict()
            assert set(got) == set(want), what
            for k, v in want.items():
                g, v = got[k].numpy(), v.numpy()
                if k.endswith(("running_mean", "running_var")):
                    np.testing.assert_allclose(g, v, atol=1e-5, err_msg=f"{what}.{k}")
                else:
                    assert_params_close(g, v, self.lr, steps_taken, f"{what}.{k}")


def assert_params_close(got, want, lr, steps_taken, what):
    diff = np.abs(got - want)
    strict = 2e-6 * max(steps_taken, 1)
    assert diff.max() <= 2 * lr + strict, (what, diff.max())
    assert np.mean(diff <= strict) >= 0.999, (what, np.mean(diff <= strict))


def assert_metrics_close(got, want):
    assert set(got) == set(want), (set(got), set(want))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def jax_train_steps():
    """The JAX steps, built once per mode for the whole module (jit caches
    their compiles across tests)."""
    built = {}

    def get(pair):
        if pair.mode not in built:
            built[pair.mode] = jax_steps.build_train_steps(pair.jgen, pair.jcritic, pair.tx, pair.tx, pair.jcfg)
        return built[pair.mode]

    return get


# --- the critic -----------------------------------------------------------


def test_default_critic_parameter_count():
    assert count_parameters(PatchGANDiscriminator()) == 176_873
    gp_critic = PatchGANDiscriminator(norm=None)
    jvars = JaxCritic(norm=None).init(jax.random.key(0), jnp.zeros((1, 32, 32, 32, 1)), train=False)
    assert count_parameters(gp_critic) == jax_count(jvars["params"]) == 176_761


@pytest.mark.parametrize("norm", ["batch", None])
@pytest.mark.parametrize("train", [True, False])
def test_critic_forward_matches_jax(norm, train):
    jc, variables, tc = carried_critic(2, norm=norm)
    x = np.random.default_rng(3).normal(0, 0.5, (3, *PATCH, 1)).astype(np.float32)
    if train and norm:
        want, upd = jc.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want, upd = jc.apply(variables, jnp.asarray(x), train=train), None
    tc.train(train)
    with torch.no_grad():
        got = tc(_t(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    assert got.shape == want.shape == (3, 1, 1, 1, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    if upd is not None:
        want_sd = critic_state_dict_from_jax({"params": variables["params"], "batch_stats": _np_tree(upd["batch_stats"])})
        for k, v in tc.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), atol=1e-5, err_msg=k)


def test_carried_critic_state_dict_covers_every_tensor():
    _, variables, tc = carried_critic(4)
    p, s = variables["params"], variables["batch_stats"]
    np.testing.assert_array_equal(tc.first.conv.weight.detach().numpy(),
                                  p["first"]["Conv_0"]["kernel"].transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(tc.first.conv.bias.detach().numpy(), p["first"]["Conv_0"]["bias"])
    np.testing.assert_array_equal(tc.middle_1.norm.weight.detach().numpy(), p["middle_1"]["BatchNorm_0"]["scale"])
    np.testing.assert_array_equal(tc.middle_0.norm.running_var.numpy(), s["middle_0"]["BatchNorm_0"]["var"])
    np.testing.assert_array_equal(tc.last.conv.bias.detach().numpy(), p["last"]["Conv_0"]["bias"])
    assert tc.middle_0.conv.bias is None and tc.last.norm is None


def test_frozen_batch_stats_keeps_running_statistics():
    _, _, tc = carried_critic(5)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 1, *PATCH)).astype(np.float32))
    before = {k: v.clone() for k, v in tc.state_dict().items()}
    tc.train()
    with frozen_batch_stats(tc):
        frozen_out = tc(x)
    for k, v in tc.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    out = tc(x)  # the flag is restored: this pass updates the statistics
    torch.testing.assert_close(out, frozen_out, rtol=0, atol=0)  # same batch statistics
    assert not torch.equal(tc.middle_0.norm.running_mean, before["middle_0.norm.running_mean"])


@pytest.mark.parametrize("kw", [dict(ndim=2), dict(norm="layer"), dict(norm="instance")])
def test_unported_critic_options_point_to_roadmap(kw):
    """``ndim=2``, ``norm="layer"`` and ``norm="instance"`` raised until
    they were ported; the critic now builds with them and matches the JAX
    critic in train mode (more in ``tests/test_torch_port_2d.py`` and
    ``tests/test_torch_port_options.py``)."""
    shape = (2,) + (32,) * kw.get("ndim", 3) + (1,)
    jc = JaxCritic(**CRITIC, **kw)
    variables = _np_tree(jc.init(jax.random.key(11), jnp.zeros(shape), train=False))
    tc = PatchGANDiscriminator(**CRITIC, **kw)
    tc.load_state_dict(critic_state_dict_from_jax(variables), strict=True)
    x = np.random.default_rng(12).normal(0, 0.5, shape).astype(np.float32)
    want, _ = jc.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = torch.movedim(tc(torch.movedim(_t(x), -1, 1)), 1, -1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# --- losses ---------------------------------------------------------------


def test_wasserstein_loss_matches_jax(rng):
    f, r = rng.normal(size=(3, 1, 2, 2, 2)), rng.normal(size=(2, 1, 2, 2, 2))
    np.testing.assert_allclose(float(losses.wasserstein_loss(_t(f), _t(r))),
                               float(jax_losses.wasserstein_loss(jnp.asarray(f, jnp.float32), jnp.asarray(r, jnp.float32))),
                               rtol=1e-6)
    np.testing.assert_allclose(float(losses.wasserstein_loss(_t(f))), float(np.float32(f).mean()), rtol=1e-6)


@pytest.mark.parametrize("scale", [1.0, 1e-6])
def test_zncc_loss_value_and_gradients_match_jax(rng, scale):
    """scale 1e-6: a near-constant source whose std is of the order of the
    backward's 1e-6 guard, where StableStd's gradient differs from the true
    one; both sides must use the guarded form."""
    s = (rng.normal(size=(2, 1, 6, 6, 6)) * scale).astype(np.float32)
    t = rng.normal(size=(2, 1, 6, 6, 6)).astype(np.float32)
    want, (ws, wt) = jax.value_and_grad(jax_losses.zncc_loss, argnums=(0, 1))(jnp.asarray(s), jnp.asarray(t))
    src, tgt = _t(s).requires_grad_(True), _t(t).requires_grad_(True)
    got = losses.zncc_loss(src, tgt)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4, atol=1e-5)
    for g, w in ((src.grad, ws), (tgt.grad, wt)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max())


def test_stable_std_backward_is_the_guarded_form(rng):
    x = _t(rng.normal(size=(50,)) * 1e-6).requires_grad_(True)
    std = losses.StableStd.apply(x)
    std.backward()
    xd = x.detach()
    want = (2.0 / 49) * (1.0 / (2 * std.detach() + 1e-6)) * (xd - xd.mean())
    torch.testing.assert_close(x.grad, want)
    torch.testing.assert_close(std.detach(), xd.std())


@pytest.mark.parametrize("mask_p", [0.2, 0.0])
def test_hu_loss_value_and_gradient_match_jax(rng, mask_p):
    """mask_p 0: no centerline voxel; the loss is 0 with a finite (zero)
    gradient, not 0/0."""
    x = rng.normal(0.2, 0.3, (2, 1, 6, 6, 6)).astype(np.float32)
    m = (rng.random((2, 1, 6, 6, 6)) < mask_p).astype(np.float32)
    lo, hi = losses.scale_bounds(FactorZeroCenterScaler(), (350.0, 450.0))
    want, wg = jax.value_and_grad(jax_losses.hu_loss)(jnp.asarray(x), jnp.asarray(m), lo, hi)
    xt = _t(x).requires_grad_(True)
    got = losses.hu_loss(xt, _t(m), lo, hi)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(wg), atol=1e-7)
    assert np.isfinite(float(got)) and torch.isfinite(xt.grad).all()


def test_scale_bounds_match_jax():
    scaler = FactorZeroCenterScaler()
    want = jax_losses.scale_bounds(jax_steps.FactorZeroCenterScaler(), (350.0, 450.0))
    assert losses.scale_bounds(scaler, (350.0, 450.0)) == want
    assert StepConfig().hu_bounds_scaled == jax_steps.StepConfig(augment=None).hu_bounds_scaled


@pytest.mark.parametrize("norm", ["batch", None])
def test_gradient_penalty_value_and_critic_gradients_match_jax(norm):
    """Fixed eps (the frameworks' random draws differ): the penalty and
    its gradient with respect to every critic parameter, through the
    double backward; a batch-norm critic runs in train mode with its
    statistics frozen."""
    jc, variables, tc = carried_critic(7, norm=norm)
    rng = np.random.default_rng(8)
    real = rng.normal(0, 0.5, (2, *PATCH, 1)).astype(np.float32)
    fake = rng.normal(0, 0.5, (2, *PATCH, 1)).astype(np.float32)
    eps = np.full((2, 1, 1, 1, 1), GP_EPS, np.float32)
    stats = variables.get("batch_stats", {})

    def jax_gp(params):
        fn = lambda x: jax_steps._apply(jc, params, stats, x, train=True)
        return jax_losses.gradient_penalty(fn, jnp.asarray(real), jnp.asarray(fake), jax.random.key(0), 10.0,
                                           eps=jnp.asarray(eps))

    want, wgrads = jax.value_and_grad(jax_gp)(jax.tree.map(jnp.asarray, variables["params"]))
    wgrads = critic_state_dict_from_jax({"params": _np_tree(wgrads)})
    tc.train()
    before = {k: v.clone() for k, v in tc.state_dict().items()}
    to_ncdhw = lambda a: _t(a).permute(0, 4, 1, 2, 3)
    with frozen_batch_stats(tc):
        got = losses.gradient_penalty(tc, to_ncdhw(real), to_ncdhw(fake), torch.Generator().manual_seed(0), 10.0,
                                      eps=_t(eps))
    names, params = zip(*tc.named_parameters())
    # the last conv's bias (and a BatchNorm shift before a piecewise-linear
    # activation) does not enter d critic / d x: no graph, a zero gradient
    grads = torch.autograd.grad(got, params, allow_unused=True)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4, atol=1e-5)
    for name, p, g in zip(names, params, grads):
        g = torch.zeros_like(p) if g is None else g
        w = wgrads[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max() + 1e-9, err_msg=name)
    for k, v in tc.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(v, before[k], rtol=0, atol=0)


def test_gradient_penalty_resamples_unequal_batches_with_the_generator():
    _, _, tc = carried_critic(9, norm=None)
    rng = np.random.default_rng(10)
    real = _t(rng.normal(size=(3, 1, *PATCH)))
    fake = _t(rng.normal(size=(2, 1, *PATCH)))
    a = losses.gradient_penalty(tc, real, fake, torch.Generator().manual_seed(1))
    b = losses.gradient_penalty(tc, real, fake, torch.Generator().manual_seed(1))
    assert a.shape == () and torch.isfinite(a) and float(a) == float(b)


# --- optimizers -----------------------------------------------------------


@pytest.mark.parametrize("kind", ["adam", "rmsprop", "sgd"])
def test_optimizer_updates_match_optax(kind):
    """Six updates with milestones [2, 4] (the lr drops after the 2nd and
    the 4th update of that optimizer); lr 0.1 so each decay shows."""
    rng = np.random.default_rng(11)
    p0 = rng.normal(size=(5, 7)).astype(np.float32)
    grads = rng.normal(size=(6, 5, 7)).astype(np.float32)
    kw = dict(lr=0.1, betas=(0.5, 0.999), milestones=[2, 4], lr_gamma=0.1)
    tx = jax_optim.make_optimizer(kind, **kw)
    jp, jopt = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    param = torch.nn.Parameter(_t(p0))
    opt = optim.make_optimizer(kind, [param], **kw)
    for g in grads:
        upd, jopt = tx.update(jnp.asarray(g), jopt, jp)
        jp = optax.apply_updates(jp, upd)
        param.grad = _t(g)
        opt.step()
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp), rtol=1e-5, atol=1e-6)
    assert opt.optimizer.param_groups[0]["lr"] == pytest.approx(0.1 * 0.01)


def test_unknown_optimizer_kind_raises():
    with pytest.raises(ValueError, match="Unknown"):
        optim.make_optimizer("lamb", [torch.nn.Parameter(torch.zeros(1))])


def test_clip_params_clamps_every_critic_parameter():
    jc, variables, tc = carried_critic(12)
    with torch.no_grad():
        for p in tc.parameters():
            p.mul_(50.0)
    want = jax_optim.clip_params(
        {k: v.numpy() * 50.0 for k, v in critic_state_dict_from_jax(variables).items() if "running" not in k}, 0.01
    )
    optim.clip_params(tc, 0.01)
    for name, p in tc.named_parameters():
        assert p.abs().max().item() <= 0.01
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[name]), rtol=1e-6, atol=0)
    assert tc.middle_0.norm.weight.detach().eq(0.01).any()  # BatchNorm scale too


# --- steps ----------------------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("branch", ["critic_step", "combined_step", "generator_only_step"])
def test_one_step_matches_jax(jax_train_steps, mode, branch):
    pair = Pair(mode)
    (opt, sub, msk), = batches(13)
    jsteps = jax_train_steps(pair)
    pair.jstate, want = getattr(jsteps, branch)(pair.jstate, opt, sub, msk)
    state = pair.port_state()
    state, got = getattr(build_train_steps(pair.cfg), branch)(state, opt, sub, msk)
    assert state.step == int(pair.jstate.step) == 1
    assert_metrics_close(got, want)
    pair.check(state, 1)
    if pair.cfg.weight_clip is not None and branch != "generator_only_step":
        assert max(p.abs().max().item() for p in state.critic.parameters()) <= 0.01


def test_trajectory_matches_jax(jax_train_steps):
    """Six iterations of the basic schedule (critic every 1, generator
    every 5), the port through ``Trainer.train_step``, JAX through its
    steps by branch name."""
    pair = Pair("wc", seed=1)
    jsteps = jax_train_steps(pair)
    trainer = Trainer(pair.tgen, pair.tcritic, pair.tx_port, pair.tx_port, pair.cfg,
                      TrainerConfig(train_critic_every=1, train_generator_every=5), device="cpu")
    pattern = schedule_branches(1, 5, 0, 6)
    assert pattern == jax_steps.schedule_branches(1, 5, 0, 6) == ("combined",) + ("critic",) * 4 + ("combined",)
    for i, ((opt, sub, msk), branch) in enumerate(zip(batches(14, n=6), pattern)):
        pair.jstate, want = getattr(jsteps, f"{branch}_step")(pair.jstate, opt, sub, msk)
        patches = {OPT: {"data": opt}, LOW: {"data": sub[:B_LOW], "seg": msk[:B_LOW], "name": ["l"]},
                   HIGH: {"data": sub[B_LOW:], "seg": msk[B_LOW:], "name": ["h"]}}
        got, (subopt, mask, names) = trainer.train_step(patches, i)
        assert names == ["l", "h"] and torch.equal(subopt, torch.from_numpy(sub))
        assert_metrics_close(got, want)
    assert trainer.state.step == 6
    pair.check(trainer.state, 6)


@pytest.mark.parametrize("s2d_factor", [4, None])
def test_generator_gradients_match_jax(s2d_factor):
    """Gradients of a generator loss through the s2d stages (B3 -> B1's
    Function on the CPU) or the direct convs, train mode, against
    jax.grad, for every parameter tensor."""
    jgen, variables, tgen = carried_generator(TINY, 15, s2d_factor=s2d_factor)
    rng = np.random.default_rng(16)
    x = rng.normal(0, 0.5, (2, *PATCH, 1)).astype(np.float32)
    r = rng.normal(size=(2, *PATCH, 1)).astype(np.float32)

    def jax_loss(params):
        out, _ = jgen.apply({"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x),
                            train=True, mutable=["batch_stats"])
        return jnp.sum(out * r)

    wgrads = generator_state_dict_from_jax({"params": _np_tree(jax.grad(jax_loss)(
        jax.tree.map(jnp.asarray, variables["params"])))})
    tgen.train()
    out = tgen(_t(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    names, params = zip(*tgen.named_parameters())
    grads = torch.autograd.grad((out * _t(r)).sum(), params)
    for name, g in zip(names, grads):
        w = wgrads[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max(), err_msg=name)
    by_name = dict(zip(names, grads))
    for name in ("first.conv.weight", "last_conv.conv.weight"):
        assert by_name[name].abs().max() > 0


@pytest.mark.parametrize("c_every,g_every,start,length", [(1, 5, 0, 12), (2, 4, 1, 9), (5, 1, 0, 6), (None, 3, 2, 5)])
def test_schedule_branches_match_jax(c_every, g_every, start, length):
    assert schedule_branches(c_every, g_every, start, length) == jax_steps.schedule_branches(
        c_every, g_every, start, length
    )


def test_trainer_none_branch_only_advances_the_step():
    pair = Pair("wc")
    trainer = Trainer(pair.tgen, pair.tcritic, pair.tx_port, pair.tx_port, pair.cfg,
                      TrainerConfig(train_critic_every=2, train_generator_every=4), device="cpu")
    before = {k: v.clone() for k, v in trainer.state.generator.state_dict().items()}
    (opt, sub, msk), = batches(17)
    patches = {OPT: {"data": opt}, LOW: {"data": sub[:1], "seg": msk[:1]}, HIGH: {"data": sub[1:], "seg": msk[1:]}}
    metrics, _ = trainer.train_step(patches, 3)
    assert metrics == {} and trainer.state.step == 1
    for k, v in trainer.state.generator.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


def test_val_steps_match_jax():
    """Eval mode, batch of 3 with the last sample marked invalid; the
    networks return to train mode afterwards."""
    pair = Pair("wc", seed=2)
    jopt, jsub = jax_steps.build_val_steps(pair.jgen, pair.jcritic, pair.jcfg)
    rng = np.random.default_rng(18)
    batch = rng.integers(-1024, 1500, (3, *PATCH)).astype(np.int16)
    w = np.array([1, 1, 0], np.float32)
    state = pair.port_state()
    vopt, vsub = build_val_steps(pair.cfg)
    np.testing.assert_allclose(float(vopt(state, batch, w)), float(jopt(pair.jstate, batch, w)), rtol=1e-4, atol=1e-6)
    got, want = vsub(state, batch, w), jsub(pair.jstate, batch, w)
    for g, wv in zip(got[:2], want[:2]):
        np.testing.assert_allclose(float(g), float(wv), rtol=1e-4, atol=1e-6)
    for g, wv in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.permute(0, 2, 3, 4, 1).numpy(), np.asarray(wv), atol=1e-4)
    assert state.generator.training and state.critic.training


def test_masked_reductions_equal_plain_ones_when_all_valid(rng):
    x = _t(rng.normal(size=(3, 1, 4, 4, 4)))
    y = _t(rng.normal(size=(3, 1, 4, 4, 4)))
    ones = torch.ones(3)
    torch.testing.assert_close(_masked_mean(x, ones), x.mean())
    torch.testing.assert_close(_masked_zncc(x, y, ones), losses.zncc_loss(x, y), rtol=1e-5, atol=1e-6)


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the rule under test is its absence")
    pair = Pair("wc")
    with pytest.raises(RuntimeError, match="cuda"):
        init_state(pair.tgen, pair.tcritic, pair.tx_port, pair.tx_port)
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(pair.tgen, pair.tcritic, pair.tx_port, pair.tx_port)


def test_augmentation_in_the_step_points_to_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        StepConfig(augment=object())


def test_generator_dropout_in_training_points_to_roadmap():
    """Generator dropout in training raised until it was ported; now
    ``init_state`` hands the dropout the state's generator and the train
    step runs (its masks: ``tests/test_torch_port_options.py``)."""
    pair = Pair("wc")
    gen = ResnetGenerator(**TINY, resnet_dropout_prob=0.1)
    state = init_state(gen, pair.tcritic, pair.tx_port, pair.tx_port, device="cpu")
    drops = [m for m in gen.modules() if m.__class__.__name__ == "Dropout"]
    assert len(drops) == TINY["n_resnet_blocks"] and all(d.generator is state.rng for d in drops)
    state, metrics = build_train_steps(pair.cfg).combined_step(state, *batches(7)[0])
    assert state.step == 1 and all(torch.isfinite(v) for v in metrics.values())
