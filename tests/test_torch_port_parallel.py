"""The port's data parallelism and patch-grid-sharded correction
(``contrast_gan_3d_tpu_torch/parallel/``) against the JAX package, on the
CPU.

Data parallelism runs in two gloo processes (``parallel/mesh.spawn_ranks``,
one spawn for the whole module, each rank on one thread, its code in
``tests/test_torch_port_parallel_ranks.py``, which imports no JAX): each
rank takes its half of the global batch, exactly as a two-device JAX mesh
shards it.
- The two-rank ``combined_step`` (WC and GP, direct and packed layouts,
  every augmentation transform on, JAX's draws for the global batch fed to
  both ranks, GP with a fixed ``eps``) against the JAX package's
  single-device ``combined_step`` on the global batch, with JAX's weights
  carried in: the tolerances of ``tests/test_torch_port_train.py``
  (metrics 1e-4 relative / 1e-5 absolute; parameters by
  ``assert_params_close``; BatchNorm statistics 1e-5).
- The same two-rank step with the port's own draws and a random GP
  ``eps`` against the port's one-process step on the global batch, at
  JAX's own DP tolerance (``tests/test_parallel.py``: metrics rtol 2e-4 /
  atol 1e-5, parameters rtol 2e-3 / atol 2e-5): the draws are the global
  batch's on every rank.
- BatchNorm's global statistics, the ZNCC and HU losses under a group
  (values and input gradients), the val steps on a batch padded to the
  ranks, the Trainer's divisibility error and ``data_mesh`` refusing more
  devices than ranks.

The sharded corrector over ``["cpu"] * k`` is held to JAX's
``make_sharded_volume_corrector`` on the 8 virtual CPU devices of
``tests/conftest.py`` at JAX's own rtol 1e-4 / atol 5e-2 HU
(``tests/test_parallel.py``).
"""

import copy
from dataclasses import replace
from functools import partial
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrast_gan_3d_tpu.parallel import data_mesh as jax_data_mesh
from contrast_gan_3d_tpu.parallel import make_sharded_volume_corrector as jax_sharded_corrector
from contrast_gan_3d_tpu.trainer import steps as jax_steps
from contrast_gan_3d_tpu_torch.eval.corrector import CCTAContrastCorrector
from contrast_gan_3d_tpu_torch.models import losses
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.models.norm import BatchNorm
from contrast_gan_3d_tpu_torch.parallel.mesh import DataMesh, pad_batch_to_multiple, spawn_ranks
from contrast_gan_3d_tpu_torch.trainer import optim
from contrast_gan_3d_tpu_torch.trainer.steps import StepConfig, build_val_steps, init_state
from contrast_gan_3d_tpu_torch.trainer.trainer import HIGH, LOW, OPT, Trainer
from tests.test_torch_port_augment import ALWAYS, JaxKeyDraws, configs
from tests.test_torch_port_models import carried_generator
from tests.test_torch_port_parallel_ranks import WORLD, _dp_worker, _one_step, _port_nets
from tests.test_torch_port_train import TINY, Pair, assert_metrics_close, batches

CASES = [(mode, layout) for mode in ("wc", "gp") for layout in ("direct", "packed")]
SHARD_CFG = dict(n_resnet_blocks=1, n_updownsample_blocks=1, init_channels_out=2)
SHARD_PATCH = (16, 16, 16)


def _case(mode, layout):
    """A ``Pair`` and the numpy / state-dict payload of one DP case."""
    pair = Pair(mode, seed=3)
    if layout == "packed":
        pair.jgen = pair.jgen.clone(layout="packed")
    jcfg, _ = configs(**ALWAYS)
    pair.jcfg = replace(pair.jcfg, augment=jcfg)
    (opt, sub, msk), = batches(21, mask_p=0.2)
    draws = JaxKeyDraws(pair.jstate.rng, jcfg)
    drawn = [draws(None, len(sub), None), draws(None, len(opt), None)]
    m = {"wc": dict(norm="batch", lr=2e-4, betas=(0.5, 0.999), weight_clip=0.01),
         "gp": dict(norm=None, lr=1e-4, betas=(0.0, 0.9), weight_clip=None)}[mode]
    case = dict(m, layout=layout, tiny=TINY, augment=ALWAYS, gen=pair.tgen.state_dict(),
                critic=pair.tcritic.state_dict(), batch=(opt, sub, msk), draws=drawn, gp_eps=pair.cfg.gp_eps)
    return pair, case


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The JAX references and the port's one-process steps here, the
    two-rank runs in one spawn."""
    tmp = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(5)
    pairs, cases = {}, {}
    for mode, layout in CASES:
        pairs[mode, layout], cases[mode, layout] = _case(mode, layout)
    payload = dict(
        cases=cases,
        bn_x=rng.normal(1.0, 2.0, (4, 3, 4, 4, 4)).astype(np.float32),
        bn_c=rng.normal(size=(4, 3, 4, 4, 4)).astype(np.float32),
        bn_state={"weight": torch.tensor([0.5, 1.0, 1.5]), "bias": torch.tensor([0.1, -0.2, 0.3]),
                  "running_mean": torch.zeros(3), "running_var": torch.ones(3)},
        loss_s=rng.normal(0.2, 0.3, (4, 1, 6, 6, 6)).astype(np.float32),
        loss_t=rng.normal(size=(4, 1, 6, 6, 6)).astype(np.float32),
        loss_m=(rng.random((4, 1, 6, 6, 6)) < 0.2).astype(np.float32),
        hu_bounds=StepConfig().hu_bounds_scaled,
        val_batch=rng.integers(-1024, 1500, (3, 16, 16, 16)).astype(np.int16),
    )
    torch.save(payload, tmp / "payload.pt")
    spawn_ranks(_dp_worker, WORLD, (str(tmp / "payload.pt"), str(tmp)), backend="gloo")
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return SimpleNamespace(pairs=pairs, cases=cases, payload=payload, ranks=ranks)


def _loaded(case, gen_state, critic_state):
    gen, critic = _port_nets(case)
    gen.load_state_dict(gen_state)
    critic.load_state_dict(critic_state)
    return SimpleNamespace(generator=gen, critic=critic)


@pytest.mark.parametrize("mode,layout", CASES)
def test_two_rank_combined_step_matches_jax_single_device(dp, mode, layout):
    pair, case = dp.pairs[mode, layout], dp.cases[mode, layout]
    opt, sub, msk = case["batch"]
    jsteps = jax_steps.build_train_steps(pair.jgen, pair.jcritic, pair.tx, pair.tx, pair.jcfg)
    pair.jstate, want = jsteps.combined_step(pair.jstate, opt, sub, msk)
    for r in dp.ranks:
        got, gen_state, critic_state, _ = r["steps"][mode, layout]
        assert_metrics_close(got, want)
        pair.check(_loaded(case, gen_state, critic_state), 1)
    # the ranks end with the same networks
    for a, b in zip(dp.ranks[0]["steps"][mode, layout][1:3], dp.ranks[1]["steps"][mode, layout][1:3]):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


@pytest.mark.parametrize("mode,layout", CASES)
def test_two_rank_combined_step_matches_the_one_rank_step(dp, mode, layout):
    """The port's own draws and a random GP eps: every rank draws the global
    batch's and keeps its slice, so the step is the one-process step on the
    global batch."""
    case = dp.cases[mode, layout]
    want, want_gen, want_critic, _ = _one_step(case, None, jax_draws=False)
    got, gen_state, critic_state, _ = dp.ranks[0]["port_steps"][mode, layout]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=1e-5, err_msg=k)
    for want_sd, got_sd in ((want_gen, gen_state), (want_critic, critic_state)):
        for k in want_sd:
            np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(), rtol=2e-3, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("mode,layout", CASES)
def test_two_rank_gradients_are_the_one_rank_gradients(dp, mode, layout):
    """The gradients both optimizers stepped with, on every rank, against
    the one-process step's on the global batch, leaf by leaf: a gradient
    counted ``WORLD`` times or ``1 / WORLD`` times, or a leaf left out of
    the all-reduce, is off by 50% or more; Adam's first update
    (``g / (|g| + eps)``) hides a constant factor, so the parameters cannot
    show it. Tolerance: 1e-4 relative plus 1e-5 of the leaf's largest
    entry (gloo's sums and the split batch reorder f32 additions)."""
    case = dp.cases[mode, layout]
    want = _one_step(case, None, jax_draws=False)[3]
    ranks = [r["port_steps"][mode, layout][3] for r in dp.ranks]
    for k in want:  # one all-reduced buffer: a leaf left out would keep each rank's own share
        assert torch.equal(ranks[0][k], ranks[1][k]), k
    for r in dp.ranks:
        got = r["port_steps"][mode, layout][3]
        assert set(got) == set(want)
        for k, w in want.items():  # WC's last critic bias has a gradient of exactly 0
            torch.testing.assert_close(got[k], w, rtol=1e-4, atol=1e-5 * w.abs().max().item(), msg=k)


def test_batchnorm_takes_global_statistics(dp):
    p = dp.payload
    bn = BatchNorm(3)
    bn.load_state_dict(p["bn_state"])
    x = torch.from_numpy(p["bn_x"]).requires_grad_(True)
    y = bn(x)
    (y * torch.from_numpy(p["bn_c"])).sum().backward()
    for r in dp.ranks:
        sl = DataMesh(r["rank"], WORLD, torch.device("cpu")).batch_slice(len(x))
        y_r, grad_r, mean_r, var_r = r["bn"]
        torch.testing.assert_close(y_r, y.detach()[sl], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(grad_r, x.grad[sl], rtol=1e-5, atol=1e-5)
        # the running variance's n is the global count (unbiased n / (n - 1))
        torch.testing.assert_close(mean_r, bn.running_mean, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(var_r, bn.running_var, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["zncc", "hu"])
def test_losses_reduce_over_the_global_batch(dp, name):
    """Each rank's loss is the global batch's; its input gradient is the
    gradient of the sum of the ranks' equal losses, ``WORLD`` times the
    one-process gradient (the convention ``reduce_gradients`` divides)."""
    p = dp.payload
    s = torch.from_numpy(p["loss_s"]).requires_grad_(True)
    if name == "zncc":
        want = losses.zncc_loss(s, torch.from_numpy(p["loss_t"]))
    else:
        want = losses.hu_loss(s, torch.from_numpy(p["loss_m"]), *p["hu_bounds"])
    want.backward()
    for r in dp.ranks:
        sl = DataMesh(r["rank"], WORLD, torch.device("cpu")).batch_slice(len(s))
        value, grad = r[name]
        np.testing.assert_allclose(value, float(want), rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(grad / WORLD, s.grad[sl], rtol=1e-5, atol=1e-8)


def test_val_steps_pad_the_batch_to_the_ranks(dp):
    """A batch of 3 over 2 ranks: padded to 4 with a weight-0 copy of its
    first sample; the masked global reductions give the unpadded values."""
    case = dp.cases["wc", "direct"]
    gen, critic = _port_nets(case)
    tx = partial(optim.make_optimizer, "adam", lr=1e-4)
    state = init_state(gen, critic, tx, tx, device="cpu")
    val_opt, val_sub = build_val_steps(StepConfig())
    batch = dp.payload["val_batch"]
    w = torch.ones(3)
    want = (float(val_opt(state, batch, w)), *(float(v) for v in val_sub(state, batch, w)[:2]))
    padded, weights = pad_batch_to_multiple(batch, WORLD)
    assert padded.shape[0] == 4 and weights.tolist() == [1, 1, 1, 0]
    np.testing.assert_array_equal(padded[3], batch[0])
    assert [r["val"][3] for r in dp.ranks] == [[1.0, 1.0], [1.0, 0.0]]
    for r in dp.ranks:
        np.testing.assert_allclose(r["val"][:3], want, rtol=1e-5, atol=1e-6)


def test_train_batches_must_divide_the_ranks_and_data_mesh_refuses_more(dp):
    for r in dp.ranks:
        assert "must be divisible by the 2 data-parallel ranks" in r["divisibility"]
        assert "only 2 ranks" in r["overrequest"]


def test_trainer_refuses_a_batch_the_ranks_do_not_divide():
    """The same check without a process group: ``_assemble`` raises before
    any collective."""
    case = _case("wc", "direct")[1]
    gen, critic = _port_nets(case)
    tx = partial(optim.make_optimizer, "adam", lr=1e-4)
    trainer = Trainer(gen, critic, tx, tx, StepConfig(), device="cpu")
    trainer.mesh = DataMesh(0, 4, torch.device("cpu"))
    b = lambda n: {"data": np.zeros((n, 16, 16, 16), np.int16), "seg": np.zeros((n, 16, 16, 16), np.int16)}
    with pytest.raises(ValueError, match="divisible by the 4 data-parallel ranks"):
        trainer._assemble({OPT: b(6), LOW: b(3), HIGH: b(3)})
    opt, sub, msk, names = trainer._assemble({OPT: b(8), LOW: b(2), HIGH: b(2)})
    assert opt.shape[0] == 2 and sub.shape[0] == msk.shape[0] == 1


# --- the sharded corrector --------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shard_nets():
    jgen, variables, tgen = carried_generator(SHARD_CFG, 2)
    return jgen, variables, tgen


@pytest.mark.parametrize("layout", ["direct", "packed"])
@pytest.mark.parametrize("shape", [(24, 20, 16), (24, 20, 18)])
def test_sharded_corrector_matches_jax_sharded_corrector(shard_nets, layout, shape):
    """Over 3 ranks' worth of CPU devices against JAX's sharded corrector on
    8 virtual devices; (24, 20, 18) is not block-aligned, where the sharded
    packed grid pads at the high end."""
    jgen, variables, tgen = shard_nets
    packed = layout == "packed"
    japply_gen = jgen.clone(layout="packed", packed_input=True, packed_output=True) if packed else jgen
    jcorrect = jax_sharded_corrector(lambda x: japply_gen.apply(variables, x, train=False), jax_data_mesh(),
                                     patch_size=SHARD_PATCH, batch_size=2, packed_io=packed)
    vol = np.random.default_rng(7).integers(-1024, 1500, shape).astype(np.int16)
    want = np.asarray(jcorrect(jnp.asarray(vol)))
    corrector = CCTAContrastCorrector(copy.deepcopy(tgen), inference_patch_size=SHARD_PATCH, batch_size=2,
                                      layout=layout, device="cpu")
    got = corrector.shard_over(["cpu"] * 3)(vol).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-2)


@pytest.mark.parametrize("layout", ["auto", "direct"])
def test_shard_over_keeps_the_layout(shard_nets, layout):
    """``shard_over`` returns the corrector, keeps its layout (auto is packed
    here) and its numbers: on a block-aligned volume the sharded result is
    the unsharded one up to the order of the sums."""
    _, _, tgen = shard_nets
    corrector = CCTAContrastCorrector(copy.deepcopy(tgen), inference_patch_size=SHARD_PATCH, batch_size=2,
                                      layout=layout, device="cpu")
    vol = np.random.default_rng(8).integers(-1024, 1500, (24, 20, 16)).astype(np.int16)
    want = corrector(vol)
    packed = corrector.packed
    assert packed == (layout == "auto")
    assert corrector.shard_over(["cpu", "cpu"]) is corrector and corrector.packed == packed
    torch.testing.assert_close(corrector(vol), want, rtol=1e-4, atol=5e-2)
    with pytest.raises(ValueError, match="3D sliding window"):
        CCTAContrastCorrector(ResnetGenerator(**SHARD_CFG, ndim=2), inference_patch_size=(16, 16),
                              device="cpu").shard_over(["cpu"])
