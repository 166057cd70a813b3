"""The port's dp x sp spatial partitioning (``parallel/spatial.py``, JAX's
``dp_sp_mesh``) against the JAX package, on the CPU, at the shapes of
``tests/test_parallel.py``: its tiny models (generator 1 / 1 / 2, critic
2 / depth 1), (32, 16, 16) patches, batches of 4 + 4.

One gloo spawn per world size (a module fixture; each rank on one thread,
its code in the JAX-free ``tests/test_torch_port_spatial_ranks.py``): two
ranks run the (1, 2) mesh, four the (2, 2) and the (1, 4) meshes. The
JAX references run here, once, and the ranks get the weights and batches
by file.
- The ``combined_step`` under each mesh (WC and GP with a fixed ``eps``,
  both ``tconv_placement``s) against the JAX package's single-device step
  on the same batch, at JAX's own dp x sp tolerance
  (``tests/test_parallel.py``: metrics rtol 2e-4 / atol 1e-5, parameters
  rtol 2e-3 / atol 2e-5); the port's one-rank step too. The GP step runs
  the penalty's double backward through the exchanged convs.
- A GP step with the options the presets can set (instance-norm
  generator with dropout and remat, layer-norm critic with remat, the
  port's own random ``eps``) against the port's one-rank step, at the
  same tolerance: the draws are the whole patches' on every rank.
- Each leaf's gradients equal on every rank.
- A 5-iteration GP cycle at (2, 2) against JAX's (rtol 5e-4 / atol 1e-4
  for metrics, rtol 5e-3 / atol 5e-5 for every parameter).
- The val steps (rtol 1e-5 / atol 1e-6), and the corrected batch
  gathered whole again.
- ``gradcheck`` and ``gradgradcheck`` in float64 of the halo exchange at
  two ranks; the refusal of a first patch dim the space axis does not
  divide.
Without a process group: the exchange plans rebuild the padded tensor
(slabs narrower than the halo, unequal slabs, ranks without output rows)
and B3 on a halo-extended slab of any number of rows equals the plain
conv of the whole tensor.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrast_gan_3d_tpu.models.discriminator import PatchGANDiscriminator as JaxCritic
from contrast_gan_3d_tpu.trainer import optim as jax_optim
from contrast_gan_3d_tpu.trainer import steps as jax_steps
from contrast_gan_3d_tpu_torch.models.discriminator import PatchGANDiscriminator
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.parallel.mesh import DataMesh, spawn_ranks
from contrast_gan_3d_tpu_torch.parallel.spatial import bounds, conv_rows, conv_window, plan
from contrast_gan_3d_tpu_torch.trainer.steps import StepConfig, schedule_branches
from contrast_gan_3d_tpu_torch.trainer import optim
from contrast_gan_3d_tpu_torch.trainer.trainer import HIGH, LOW, OPT, Trainer
from contrast_gan_3d_tpu_torch.utils.weights import critic_state_dict_from_jax, generator_state_dict_from_jax
from tests.test_torch_port_models import _np_tree, carried_generator, randomize_norms
from tests.test_torch_port_spatial_ranks import CYCLE_MESH, MESHES, cycle, one_step, sp_worker, val

PATCH = (32, 16, 16)
GEN = dict(n_resnet_blocks=1, n_updownsample_blocks=1, init_channels_out=2)
CRITIC = dict(init_channels_out=2, discriminator_depth=1)
LR, BETAS, GP_EPS = 1e-3, (0.5, 0.999), 0.3
# (mode, tconv_placement, generator layout); the direct cases first
JAX_CASES = [(mode, placement, layout) for layout in ("direct", "packed") for mode in ("wc", "gp")
             for placement in ("same", "torch")]
PACKED_CASES = [key for key in JAX_CASES if key[2] == "packed"]
OPTIONS = ("gp", "options")
METRIC_TOL = dict(rtol=2e-4, atol=1e-5)
PARAM_TOL = dict(rtol=2e-3, atol=2e-5)


def _case(mode, placement, layout="direct", seed=0):
    """The JAX nets and state, and the port's case (the same weights, as
    state dicts)."""
    jgen, gvars, tgen = carried_generator(GEN, seed, shape=(1, *PATCH, 1), tconv_placement=placement,
                                          layout=layout)
    jcritic = JaxCritic(**CRITIC)
    cvars = jcritic.init(jax.random.key(seed + 1), jnp.zeros((1, *PATCH, 1)), train=False)
    cvars = randomize_norms(_np_tree(cvars), np.random.default_rng(seed + 1))
    tcritic = PatchGANDiscriminator(**CRITIC)
    tcritic.load_state_dict(critic_state_dict_from_jax(cvars), strict=True)
    tx = jax_optim.make_optimizer(lr=LR, betas=BETAS)
    as_j = lambda t: jax.tree.map(jnp.asarray, t)
    jcfg = jax_steps.StepConfig(weight_clip=0.01 if mode == "wc" else None, augment=None,
                                gp_eps=None if mode == "wc" else GP_EPS)
    jstate = jax_steps.GANTrainState(
        step=jnp.zeros((), jnp.int32), gen_params=as_j(gvars["params"]), gen_stats=as_j(gvars["batch_stats"]),
        critic_params=as_j(cvars["params"]), critic_stats=as_j(cvars["batch_stats"]),
        gen_opt=tx.init(as_j(gvars["params"])), critic_opt=tx.init(as_j(cvars["params"])), rng=jax.random.key(seed))
    case = dict(gen_kw=dict(GEN, tconv_placement=placement, layout=layout), critic_kw=CRITIC, gen=tgen.state_dict(),
                critic=tcritic.state_dict(), lr=LR, betas=BETAS, seed=0, weight_clip=jcfg.weight_clip,
                gp_eps=jcfg.gp_eps)
    return SimpleNamespace(jgen=jgen, jcritic=jcritic, tx=tx, jcfg=jcfg, jstate=jstate, case=case)


def _options_case():
    """GP with the options: instance norm, dropout and remat in the
    generator, layer norm and remat in the critic, the port's own eps."""
    torch.manual_seed(3)
    gen_kw = dict(GEN, norm="instance", resnet_dropout_prob=0.5, remat=True)
    critic_kw = dict(CRITIC, norm="layer", remat=True)
    return dict(gen_kw=gen_kw, critic_kw=critic_kw, gen=ResnetGenerator(**gen_kw).state_dict(),
                critic=PatchGANDiscriminator(**critic_kw).state_dict(), lr=LR, betas=(0.0, 0.9), seed=4,
                weight_clip=None, gp_eps=None)


def _state_dicts(jstate):
    gen = generator_state_dict_from_jax({"params": _np_tree(jstate.gen_params),
                                         "batch_stats": _np_tree(jstate.gen_stats)})
    critic = critic_state_dict_from_jax({"params": _np_tree(jstate.critic_params),
                                         "batch_stats": _np_tree(jstate.critic_stats)})
    return gen, critic


def _batches(rng, k=None, b=4):
    lead = (b,) if k is None else (k, b)
    opt = rng.integers(-500, 500, (*lead, *PATCH)).astype(np.int16)
    sub = rng.integers(-500, 500, (*lead, *PATCH)).astype(np.int16)
    msk = (rng.random((*lead, *PATCH)) < 0.01).astype(np.int16)
    return opt, sub, msk


@pytest.fixture(scope="module")
def sp(tmp_path_factory):
    """JAX's references and the port's one-rank steps here; the ranks of
    both world sizes in one spawn each."""
    tmp = tmp_path_factory.mktemp("sp")
    rng = np.random.default_rng(0)
    batch = _batches(rng)
    pairs = {key: _case(*key) for key in JAX_CASES}
    # the val steps, on the WC case's initial state (the train steps donate it)
    val_batch = rng.integers(-500, 500, (4, *PATCH)).astype(np.int16)
    w = jnp.ones((4,), jnp.float32)
    want_val = {}
    for layout in ("direct", "packed"):
        vpair = pairs["wc", "same", layout]
        vo, vs = jax_steps.build_val_steps(vpair.jgen, vpair.jcritic, jax_steps.StepConfig(augment=None))
        sub = vs(vpair.jstate, jnp.asarray(val_batch), w)
        want_val[layout] = (float(vo(vpair.jstate, jnp.asarray(val_batch), w)), float(sub[0]), float(sub[1]),
                            np.asarray(sub[2]).transpose(0, 4, 1, 2, 3))
    want = {}
    for key, pair in pairs.items():
        jsteps = jax_steps.build_train_steps(pair.jgen, pair.jcritic, pair.tx, pair.tx, pair.jcfg)
        jstate, metrics = jsteps.combined_step(pair.jstate, *(jnp.asarray(b) for b in batch))
        want[key] = ({k: float(v) for k, v in metrics.items()}, *_state_dicts(jstate))
    cases = {key: pair.case for key, pair in pairs.items()}
    cases[OPTIONS] = _options_case()
    # the GP cycle: four critic iterations after a combined one
    pattern = schedule_branches(1, 5, 0, 5)
    cycle_batches = _batches(rng, k=len(pattern))
    cpair = _case("gp", "same", seed=1)
    jcycle = jax_steps.build_cycle_step(
        jax_steps.build_train_steps(cpair.jgen, cpair.jcritic, cpair.tx, cpair.tx, cpair.jcfg), pattern)
    jstate, metrics = jcycle(cpair.jstate, *(jnp.asarray(b) for b in cycle_batches))
    want_cycle = ({k: float(v) for k, v in metrics.items()}, *_state_dicts(jstate))
    payload = dict(cases=cases, batch=batch, cycle_case=cpair.case, cycle_batches=cycle_batches, pattern=pattern,
                   val_batch=val_batch)
    torch.save(payload, tmp / "payload.pt")
    ranks = {}
    for world in MESHES:
        out = tmp / f"world{world}"
        out.mkdir()
        spawn_ranks(sp_worker, world, (str(tmp / "payload.pt"), str(out)), backend="gloo", timeout=120)
        for r in range(world):
            for shape, res in torch.load(out / f"rank{r}.pt", weights_only=False).items():
                ranks.setdefault(shape, []).append(res)
    return SimpleNamespace(payload=payload, want=want, want_cycle=want_cycle, want_val=want_val, ranks=ranks)


MESH_SHAPES = [shape for shapes in MESHES.values() for shape in shapes]


def _close_states(got, want, tol):
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), err_msg=k, **tol)


def _close_metrics(got, want, tol):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, err_msg=k, **tol)


@pytest.mark.parametrize("key", JAX_CASES)
def test_one_rank_step_matches_jax(sp, key):
    """The port's one-rank step on the same batch, JAX's dp x sp
    tolerance (the reference the meshes are held to)."""
    metrics, gen, critic, _ = one_step(sp.payload["cases"][key], sp.payload["batch"])
    want_metrics, want_gen, want_critic = sp.want[key]
    _close_metrics(metrics, want_metrics, METRIC_TOL)
    _close_states(gen, want_gen, PARAM_TOL)
    _close_states(critic, want_critic, PARAM_TOL)


@pytest.mark.parametrize("key", JAX_CASES)
@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_dp_sp_step_matches_jax_single_device(sp, shape, key):
    want_metrics, want_gen, want_critic = sp.want[key]
    for res in sp.ranks[shape]:
        metrics, gen, critic, _ = res["steps"][key]
        _close_metrics(metrics, want_metrics, METRIC_TOL)
        _close_states(gen, want_gen, PARAM_TOL)
        _close_states(critic, want_critic, PARAM_TOL)


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_dp_sp_step_with_the_options_matches_the_one_rank_step(sp, shape):
    """Instance norm, dropout and remat in the generator, layer norm and
    remat in the critic, the port's own GP eps: the masks and the eps are
    drawn for the whole patches of the global batch on every rank."""
    want_metrics, want_gen, want_critic, want_grads = one_step(sp.payload["cases"][OPTIONS], sp.payload["batch"])
    for res in sp.ranks[shape]:
        metrics, gen, critic, grads = res["steps"][OPTIONS]
        _close_metrics(metrics, want_metrics, METRIC_TOL)
        _close_states(gen, want_gen, PARAM_TOL)
        _close_states(critic, want_critic, PARAM_TOL)
        for k, w in want_grads.items():
            torch.testing.assert_close(grads[k], w, rtol=1e-4, atol=1e-5 * w.abs().max().item(), msg=k)


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_every_rank_steps_with_the_same_gradients(sp, shape):
    ranks = sp.ranks[shape]
    for key in [*JAX_CASES, OPTIONS]:
        first = ranks[0]["steps"][key]
        for res in ranks[1:]:
            for k, g in res["steps"][key][3].items():
                assert torch.equal(g, first[3][k]), (key, k)
            for a, b in zip(res["steps"][key][1:3], first[1:3]):
                assert all(torch.equal(a[k], b[k]) for k in a), key


def test_dp_sp_gp_cycle_matches_jax(sp):
    """Five GP iterations (a combined step, then four critic steps), each
    penalty's double backward through the exchanged convs; gloo cycles run
    eagerly."""
    want_metrics, want_gen, want_critic = sp.want_cycle
    one = cycle(sp.payload["cycle_case"], sp.payload["cycle_batches"], sp.payload["pattern"])
    for metrics, gen, critic, calls in [one, *(r["cycle"] for r in sp.ranks[CYCLE_MESH])]:
        assert calls == {"eager": 1, "capture": 0, "replay": 0}
        _close_metrics(metrics, want_metrics, dict(rtol=5e-4, atol=1e-4))
        _close_states(gen, want_gen, dict(rtol=5e-3, atol=5e-5))
        _close_states(critic, want_critic, dict(rtol=5e-3, atol=5e-5))


def _check_val(sp, shape, layout, key):
    opt, realism, zncc, sample_hat = sp.want_val[layout]
    got_one = val(sp.payload["cases"]["wc", "same", layout], sp.payload["val_batch"])
    for got in [got_one, *(r[key] for r in sp.ranks[shape])]:
        np.testing.assert_allclose(got[:3], (opt, realism, zncc), rtol=1e-5, atol=1e-6)
    for res in sp.ranks[shape]:
        d = res["rank"] // shape[1]
        np.testing.assert_allclose(res[key][3].numpy(), sample_hat[d * 4 // shape[0]:(d + 1) * 4 // shape[0]],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_dp_sp_val_steps_match_jax(sp, shape):
    _check_val(sp, shape, "direct", "val")


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_dp_sp_packed_val_steps_match_jax(sp, shape):
    """The val steps with the packed generator: its slabs' corrections
    gathered whole again (``gather_slab``)."""
    _check_val(sp, shape, "packed", "val_packed")


@pytest.mark.parametrize("key", PACKED_CASES)
@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_dp_sp_packed_step_matches_the_one_rank_step(sp, shape, key):
    """The packed layout's slabs (whole f4 blocks at 8 rows a slab at
    (1, 4)) against the port's one-rank packed step: metrics and states
    at JAX's dp x sp tolerance, gradients within 1e-4 relative and 1e-5
    of a leaf's largest entry."""
    want_metrics, want_gen, want_critic, want_grads = one_step(sp.payload["cases"][key], sp.payload["batch"])
    for res in sp.ranks[shape]:
        metrics, gen, critic, grads = res["steps"][key]
        _close_metrics(metrics, want_metrics, METRIC_TOL)
        _close_states(gen, want_gen, PARAM_TOL)
        _close_states(critic, want_critic, PARAM_TOL)
        for k, w in want_grads.items():
            torch.testing.assert_close(grads[k], w, rtol=1e-4, atol=1e-5 * w.abs().max().item(), msg=k)


@pytest.mark.parametrize("check", ["reflect 7", "zeros k4 s2", "tconv torch"])
def test_halo_exchange_gradcheck_and_gradgradcheck(sp, check):
    for res in sp.ranks[1, 2]:
        assert res["halo"][check] == (True, True)


@pytest.mark.parametrize("check", ["packed stem reflect", "packed projection reflect", "packed down zeros",
                                   "packed tconv torch"])
def test_packed_exchange_matches_the_whole_and_gradchecks(sp, check):
    """float64, two ranks: each rank's slab of the packed conv equals its
    share of the conv of the whole tensor, and ``gradcheck`` /
    ``gradgradcheck`` pass through the block-row exchange (the reflect
    ends rebuilt on the first and the last slab)."""
    for res in sp.ranks[1, 2]:
        assert res["halo"][check] == (True, True, True)


def test_trainer_rejects_nondivisible_spatial_dim():
    """JAX's check (``trainer.py`` ``_assemble``): under a (2, 4) mesh a
    first patch dim of 10 does not split over the space axis; 12 does, and
    the patches stay whole (the step keeps each rank's slab)."""
    tx = lambda params: optim.make_optimizer("adam", params, lr=LR)
    trainer = Trainer(ResnetGenerator(**GEN), PatchGANDiscriminator(**CRITIC), tx, tx, StepConfig(), device="cpu")
    trainer.mesh = DataMesh(0, 8, torch.device("cpu"), space=4)
    b = lambda n, x: {"data": np.zeros((n, x, 8, 8), np.int16), "seg": np.zeros((n, x, 8, 8), np.int16)}
    with pytest.raises(ValueError, match="spatial-partitioning"):
        trainer._assemble({OPT: b(2, 10), LOW: b(1, 10), HIGH: b(1, 10)})
    opt, sub, msk, _ = trainer._assemble({OPT: b(2, 12), LOW: b(1, 12), HIGH: b(1, 12)})
    assert opt.shape == sub.shape == msk.shape == (1, 12, 8, 8)


def _simulated_exchange(x, n, space, windows, mode):
    """Every rank's extended slab from ``plan``, the all-reduce summed
    here over the ranks' writes (no process group)."""
    plans = [plan(n, space, r, tuple(windows), mode) for r in range(space)]
    slabs = [x[lo:hi] for lo, hi in (bounds(n, space, r) for r in range(space))]
    buf = torch.zeros((plans[0].total, *x.shape[1:]), dtype=x.dtype)
    for p, slab in zip(plans, slabs):
        for local, slot, count in p.sends:
            buf[slot:slot + count] += slab[local:local + count]
    out = []
    for p, slab in zip(plans, slabs):
        recv = buf[p.recv[0]:p.recv[0] + p.recv[1]]
        parts = []
        for kind, start, count, step in p.pieces:
            if kind == "zero":
                parts.append(torch.zeros((count, *x.shape[1:]), dtype=x.dtype))
            else:
                src = slab if kind == "local" else recv
                part = src[start if step == 1 else start - count + 1:][:count]
                parts.append(part if step == 1 else part.flip(0))
        out.append(torch.cat(parts))
    return out


@pytest.mark.parametrize("n,space,k,s,p,mode", [
    (16, 2, 7, 1, 3, "reflect"),  # the stem at two ranks
    (8, 4, 7, 1, 3, "reflect"),   # slabs of 2 rows: the halo reaches past the neighbour, reflect across ranks
    (8, 4, 3, 2, 1, "zeros"),     # a stride-2 downsample
    (4, 4, 4, 2, 1, "zeros"),     # a critic layer with fewer output rows than ranks (phantom rows)
    (7, 4, 4, 1, 1, "zeros"),     # the critic's last conv on unequal slabs
])
def test_halo_plans_rebuild_the_padded_tensor(n, space, k, s, p, mode):
    x = torch.arange(n * 3, dtype=torch.float64).reshape(n, 3) + 1
    pad = max(p, k)
    whole = torch.nn.functional.pad(x.T[None], (pad, pad), mode="reflect" if mode == "reflect" and pad < n
                                    else "constant")[0].T
    if mode == "reflect" and pad >= n:  # reflect as far as rows exist, zeros beyond
        whole = torch.cat([torch.zeros(pad - p, 3, dtype=x.dtype),
                           torch.nn.functional.pad(x.T[None], (p, p), mode="reflect")[0].T,
                           torch.zeros(pad - p, 3, dtype=x.dtype)])
    n_out = conv_rows(n, k, s, p)
    windows = [conv_window(o0, max(o1, o0 + 1), k, s, p) for o0, o1 in
               (bounds(n_out, space, q) for q in range(space))]
    for (lo, hi), got in zip(windows, _simulated_exchange(x, n, space, windows, mode)):
        torch.testing.assert_close(got, whole[lo + pad:hi + pad], rtol=0, atol=0)


@pytest.mark.parametrize("rows", [8, 10, 7, 1])
def test_b3_on_a_halo_extended_slab_is_b3_on_the_whole(rows, monkeypatch):
    """``s2d_conv3d_block(halo=True)`` on X rows already extended by the
    conv's halo (here the reflect pad itself) equals the plain conv of the
    whole tensor (float64), with and without a gradient, through B1 whatever the
    rows (a slab's own rows need not divide f: the block grid is rounded up
    with zeros; a slab of fewer rows than the halo takes zeros here), and
    its operator checks out; ``S2DConv.forward_slab``
    runs the same kernel. Y or Z that do not divide f are refused."""
    from contrast_gan_3d_tpu_torch.models.blocks import S2DConv
    from contrast_gan_3d_tpu_torch.ops import block_conv
    from contrast_gan_3d_tpu_torch.ops.block_conv import s2d_conv3d_block, s2d_conv3d_block_op
    from contrast_gan_3d_tpu_torch.ops.s2d_conv import reflect_pad

    b1 = []
    kernel = block_conv.block_conv3x3x3
    monkeypatch.setattr(block_conv, "block_conv3x3x3", lambda *a: b1.append(1) or kernel(*a))
    g = torch.Generator().manual_seed(0)
    x, w, b = (torch.randn(*shape, generator=g, dtype=torch.float64) for shape in ((2, rows, 12, 4, 2),
                                                                                (7, 7, 7, 2, 3), (3,)))
    # the slab as the first and the last at once: reflected at both ends,
    # or zero-extended where it has too few rows to reflect
    ext = reflect_pad(x, [(3, 3)], dims=[1]) if rows > 3 else torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 0, 3, 3))
    whole = torch.nn.functional.pad(ext.permute(0, 4, 1, 2, 3), (3, 3, 3, 3, 0, 0), mode="reflect")
    want = torch.nn.functional.conv3d(whole, w.permute(4, 3, 0, 1, 2), b).permute(0, 2, 3, 4, 1)
    ext.requires_grad_(True)
    got = s2d_conv3d_block(ext, w, b, padding_mode="reflect", halo=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    got.sum().backward()
    assert ext.grad.shape == ext.shape and ext.grad[:, :3].abs().sum() > 0
    with torch.no_grad():
        torch.testing.assert_close(s2d_conv3d_block(ext, w, b, padding_mode="reflect", halo=True), want,
                                   rtol=1e-5, atol=1e-5)
    assert len(b1) == 2
    conv = S2DConv(2, 3, 7, padding_mode="reflect", dtype=torch.float64).double()
    with torch.no_grad():
        conv.weight.copy_(w.permute(4, 3, 0, 1, 2))
        conv.bias.copy_(b)
        torch.testing.assert_close(conv.forward_slab(ext.detach().permute(0, 4, 1, 2, 3)),
                                   want.permute(0, 4, 1, 2, 3), rtol=1e-5, atol=1e-5)
    assert len(b1) == 3
    torch.library.opcheck(s2d_conv3d_block_op, (ext.detach(), w, b, 4, "reflect", True))
    with pytest.raises(ValueError, match="halo=True"):
        s2d_conv3d_block(ext[:, :, 1:], w, b, padding_mode="reflect", halo=True)


@pytest.mark.parametrize("nb,space,mode", [
    (8, 2, "reflect"),   # the stem's f2 blocks at two ranks (L = 2 blocks of 2 voxels)
    (11, 3, "reflect"),  # unequal slabs of 3, 4, 4 blocks: the first only just holds its L+1 boundary blocks
    (16, 4, "zeros"),    # a stride-2 downsample (3 block taps at block stride 2, one zero block a side)
    (10, 4, "zeros"),    # unequal slabs of 2, 3, 2, 3 blocks
])
def test_packed_block_plans_rebuild_the_padded_tensor(nb, space, mode):
    """Without a process group: the exchange plans in block rows (the
    all-reduce summed here), then the reflect ends of the first and the
    last slab built from their own boundary blocks
    (``ops/packed.reflect_slab_ends``), give each rank the block rows of
    the whole tensor padded as one device pads it:
    ``reflect_pad_packed``'s 7^3 stem pad, or whole zero blocks."""
    from contrast_gan_3d_tpu_torch.ops.packed import _packed_K, reflect_pad_packed, reflect_slab_ends
    from contrast_gan_3d_tpu_torch.ops.s2d_conv import zero_pad_cl

    f = 2
    x = torch.arange(nb * 3 * 3 * 8 * 2, dtype=torch.float64).reshape(1, nb, 3, 3, 8 * 2) + 1
    if mode == "reflect":
        L, K, b_stride, n_out = 2, _packed_K(7, 2, 2, 1, 1), 1, nb
        whole = reflect_pad_packed(x, f, 3, axes=(0,))[0]
    else:
        L, K, b_stride, n_out = 1, _packed_K(3, 2, 2, 2, 1), 2, nb // 2
        whole = zero_pad_cl(x, [(L, L), (0, 0), (0, 0)])
    windows = [conv_window(o0, max(o1, o0 + 1), K, b_stride, L) for o0, o1 in
               (bounds(n_out, space, q) for q in range(space))]
    exts = _simulated_exchange(x.transpose(0, 1), nb, space, windows, "zeros")
    for q, ((lo, hi), ext) in enumerate(zip(windows, exts)):
        ext = ext.transpose(0, 1)
        if mode == "reflect":
            s0, s1 = bounds(nb, space, q)
            ext = reflect_slab_ends(ext, x[:, s0:s1], f, L, lo, nb)
        rows = whole[:, lo + L:hi + L]
        torch.testing.assert_close(ext[:, :rows.shape[1]], rows, rtol=0, atol=0)
        assert not ext[:, rows.shape[1]:].any()  # beyond the padded tensor: zero blocks (the conv's extension)


def test_resolve_layout_under_sp_devices():
    """basic_3d under ``sp_devices=2`` resolves to the packed layout (slabs
    of 64 rows); a first patch dim whose slabs are not whole blocks at
    every stage (36 over 2: 18 rows, not a multiple of 4) resolves to
    direct under "auto" and raises under an explicit "packed"; at 4 ranks
    a 32-row patch (slabs of 8) is packed, a 16-row one (slabs of 4, under
    the reflect pad's 8) direct."""
    import dataclasses

    from contrast_gan_3d_tpu_torch.experiments import builder, config

    cfg = dataclasses.replace(config.PRESETS["basic_3d"](), sp_devices=2)
    assert builder.resolve_layout(cfg) == "packed"
    odd = dataclasses.replace(cfg, train_patch_size=(36, 128, 128))
    assert builder.resolve_layout(odd) == "direct"
    with pytest.raises(ValueError, match=r"slabs of \[18\] rows"):
        builder.resolve_layout(dataclasses.replace(odd, generator_layout="packed"))
    four = dict(sp_devices=4, generator_args=dict(GEN))
    assert builder.resolve_layout(dataclasses.replace(cfg, train_patch_size=PATCH, val_patch_size=PATCH,
                                                      **four)) == "packed"
    assert builder.resolve_layout(dataclasses.replace(cfg, train_patch_size=(16, 16, 16),
                                                      val_patch_size=(16, 16, 16), **four)) == "direct"
