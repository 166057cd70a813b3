"""The port's dp x sp spatial partitioning of the 2D family (``conf_2d``,
``gradient_penalty_2d``, ``test_conf_2d``) against the JAX package, on the
CPU: the 2D counterparts of ``tests/test_torch_port_spatial.py``'s cases.
The slab is the first dim of each NCHW slice (H, dim 2, as X is in 3D);
the generator stays on the direct layout. Tiny models (generator 1 / 1 /
2, critic 2 / depth 1, ``ndim=2``), (32, 16) slices, batches of 4 + 4.

One gloo spawn per world size (a module fixture; each rank on one thread,
its code in the JAX-free ``tests/test_torch_port_spatial_2d_ranks.py``):
two ranks run the (1, 2) mesh, four the (2, 2) and the (1, 4) meshes.
JAX's references run here, once: its single-device step and its own dp x
sp step (GSPMD on the virtual CPU devices) of every mesh.
- The ``combined_step`` under each mesh (WC and GP with a fixed ``eps``,
  both ``tconv_placement``s) against both JAX steps, at JAX's own dp x sp
  tolerance (``tests/test_parallel.py``: metrics rtol 2e-4 / atol 1e-5,
  parameters rtol 2e-3 / atol 2e-5).
- The phantom-row critic: conf_2d's depth-3 critic on 32^2 slices leaves
  2 rows after its last stride-2 block and 1 logit row, so at 2 and 4
  ranks some ranks hold no logit rows and compute a phantom one; a GP
  step against JAX's single-device step, and JAX's (1, 2) step (JAX's
  own GSPMD step leaves its single-device one at (2, 2) and (1, 4)).
- A GP step with the options (instance-norm generator with dropout and
  remat, layer-norm critic with remat, the port's own ``eps``) and a WC
  step that rotates and mirrors the slices on the device, with its
  preview, against the port's one-rank steps: the draws are the whole
  slices' on every rank. Each leaf's gradients equal on every rank.
- The val steps at (32, 16) and at 512^2 (256 rows a rank at (1, 2))
  against JAX's, the corrected batch gathered whole.
Without a process group: each rank's slab of a 2D conv block's output,
from the halo-extended slab the exchange plans build, equals its share of
the conv of the whole slice (reflect and zero padding, strides 1 and 2,
both transpose-conv placements, ranks without output rows), and the train
CLI refuses slices whose first dim the ranks do not divide. Then ``train
--sp-devices 2`` on a tiny ``conf_2d`` override (its own two-rank spawn)
against the one-rank run.
"""

import json
import pickle
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrast_gan_3d_tpu.models.discriminator import PatchGANDiscriminator as JaxCritic
from contrast_gan_3d_tpu.parallel import dp_sp_mesh as jax_dp_sp_mesh
from contrast_gan_3d_tpu.parallel.mesh import put_batch, put_replicated
from contrast_gan_3d_tpu.trainer import optim as jax_optim
from contrast_gan_3d_tpu.trainer import steps as jax_steps
from contrast_gan_3d_tpu_torch import train as train_cli
from contrast_gan_3d_tpu_torch.models import blocks
from contrast_gan_3d_tpu_torch.models.blocks import ConvBlock
from contrast_gan_3d_tpu_torch.models.discriminator import PatchGANDiscriminator
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.parallel.mesh import spawn_ranks
from contrast_gan_3d_tpu_torch.parallel.spatial import bounds
from contrast_gan_3d_tpu_torch.utils.weights import critic_state_dict_from_jax
from tests.test_torch_port_models import _np_tree, carried_generator, randomize_norms
from tests.test_torch_port_spatial import _simulated_exchange, _state_dicts
from tests.test_torch_port_spatial_2d_ranks import AUGMENT, MESHES, VAL, augment_step, slices, sp_2d_worker
from tests.test_torch_port_spatial_ranks import one_step, val

PATCH = (32, 16)
PHANTOM_PATCH = (32, 32)
VAL_512 = (512, 512)
GEN = dict(n_resnet_blocks=1, n_updownsample_blocks=1, init_channels_out=2, ndim=2)
CRITIC = dict(init_channels_out=2, discriminator_depth=1, ndim=2)
DEEP_CRITIC = dict(CRITIC, discriminator_depth=3)  # conf_2d's depth
LR, BETAS, GP_EPS = 1e-3, (0.5, 0.999), 0.3
JAX_CASES = [(mode, placement) for mode in ("wc", "gp") for placement in ("same", "torch")]
PHANTOM = ("phantom",)
OPTIONS = ("options",)
METRIC_TOL = dict(rtol=2e-4, atol=1e-5)
PARAM_TOL = dict(rtol=2e-3, atol=2e-5)
MESH_SHAPES = [shape for shapes in MESHES.values() for shape in shapes]


def _case(mode, placement, critic_kw=CRITIC, patch=PATCH, seed=0):
    """The JAX nets and state, and the port's case (the same weights, as
    state dicts)."""
    jgen, gvars, tgen = carried_generator(GEN, seed, shape=(1, *patch, 1), tconv_placement=placement)
    jcritic = JaxCritic(**critic_kw)
    cvars = jcritic.init(jax.random.key(seed + 1), jnp.zeros((1, *patch, 1)), train=False)
    cvars = randomize_norms(_np_tree(cvars), np.random.default_rng(seed + 1))
    tcritic = PatchGANDiscriminator(**critic_kw)
    tcritic.load_state_dict(critic_state_dict_from_jax(cvars), strict=True)
    tx = jax_optim.make_optimizer(lr=LR, betas=BETAS)
    as_j = lambda t: jax.tree.map(jnp.asarray, t)
    jcfg = jax_steps.StepConfig(weight_clip=0.01 if mode == "wc" else None, augment=None,
                                gp_eps=None if mode == "wc" else GP_EPS)
    make_state = lambda: jax_steps.GANTrainState(
        step=jnp.zeros((), jnp.int32), gen_params=as_j(gvars["params"]), gen_stats=as_j(gvars["batch_stats"]),
        critic_params=as_j(cvars["params"]), critic_stats=as_j(cvars["batch_stats"]),
        gen_opt=tx.init(as_j(gvars["params"])), critic_opt=tx.init(as_j(cvars["params"])), rng=jax.random.key(seed))
    case = dict(gen_kw=dict(GEN, tconv_placement=placement), critic_kw=critic_kw, gen=tgen.state_dict(),
                critic=tcritic.state_dict(), lr=LR, betas=BETAS, seed=0, weight_clip=jcfg.weight_clip,
                gp_eps=jcfg.gp_eps)
    return SimpleNamespace(jgen=jgen, jcritic=jcritic, tx=tx, jcfg=jcfg, make_state=make_state, case=case)


def _jax_step(pair, batch, mesh=None):
    """JAX's ``combined_step`` on one device, or under GSPMD on ``mesh``
    (the batch's first spatial dim sharded over its space axis): (metrics,
    generator state dict, critic state dict)."""
    steps = jax_steps.build_train_steps(pair.jgen, pair.jcritic, pair.tx, pair.tx, pair.jcfg, mesh=mesh)
    state = pair.make_state()
    if mesh is None:
        args = tuple(jnp.asarray(b) for b in batch)
    else:
        state, args = put_replicated(state, mesh), tuple(put_batch(jnp.asarray(b), mesh) for b in batch)
    state, metrics = steps.combined_step(state, *args)
    return ({k: float(v) for k, v in metrics.items()}, *_state_dicts(jax.device_get(state)))


def _jax_val(pair, batch):
    vo, vs = jax_steps.build_val_steps(pair.jgen, pair.jcritic, jax_steps.StepConfig(augment=None))
    state, w = pair.make_state(), jnp.ones((len(batch),), jnp.float32)
    sub = vs(state, jnp.asarray(batch), w)
    return float(vo(state, jnp.asarray(batch), w)), float(sub[0]), float(sub[1]), np.asarray(sub[2])[..., 0]


def _options_case():
    """GP with the options: instance norm, dropout and remat in the
    generator, layer norm and remat in the critic, the port's own eps."""
    torch.manual_seed(3)
    gen_kw = dict(GEN, norm="instance", resnet_dropout_prob=0.5, remat=True)
    critic_kw = dict(CRITIC, norm="layer", remat=True)
    return dict(gen_kw=gen_kw, critic_kw=critic_kw, gen=ResnetGenerator(**gen_kw).state_dict(),
                critic=PatchGANDiscriminator(**critic_kw).state_dict(), lr=LR, betas=(0.0, 0.9), seed=4,
                weight_clip=None, gp_eps=None)


@pytest.fixture(scope="module")
def sp(tmp_path_factory):
    """JAX's references here; the ranks of both world sizes in one spawn
    each."""
    tmp = tmp_path_factory.mktemp("sp2d")
    rng = np.random.default_rng(0)
    batch = slices(rng, PATCH)
    phantom_batch = slices(rng, PHANTOM_PATCH)
    pairs = {key: _case(*key) for key in JAX_CASES}
    ppair = _case("gp", "same", critic_kw=DEEP_CRITIC, patch=PHANTOM_PATCH, seed=2)
    want = {key: _jax_step(pair, batch) for key, pair in pairs.items()}
    want[PHANTOM] = _jax_step(ppair, phantom_batch)
    want_mesh = {(shape, key): _jax_step(pair, batch, jax_dp_sp_mesh(*shape))
                 for shape in MESH_SHAPES for key, pair in pairs.items()}
    want_mesh[(1, 2), PHANTOM] = _jax_step(ppair, phantom_batch, jax_dp_sp_mesh(1, 2))
    val_batch = rng.integers(-500, 500, (4, *PATCH)).astype(np.int16)
    val_batch_512 = rng.integers(-500, 500, (2, *VAL_512)).astype(np.int16)
    want_val = {"val": _jax_val(pairs[VAL], val_batch), "val_512": _jax_val(pairs[VAL], val_batch_512)}
    cases = {key: pair.case for key, pair in pairs.items()}
    cases[PHANTOM], cases[OPTIONS], cases[AUGMENT] = ppair.case, _options_case(), pairs[VAL].case
    batches = {key: phantom_batch if key == PHANTOM else batch for key in cases}
    payload = dict(cases=cases, batches=batches, val_batch=val_batch, val_batch_512=val_batch_512)
    torch.save(payload, tmp / "payload.pt")
    ranks = {}
    for world in MESHES:
        out = tmp / f"world{world}"
        out.mkdir()
        spawn_ranks(sp_2d_worker, world, (str(tmp / "payload.pt"), str(out)), backend="gloo", timeout=120)
        for r in range(world):
            for shape, res in torch.load(out / f"rank{r}.pt", weights_only=False).items():
                ranks.setdefault(shape, []).append(res)
    return SimpleNamespace(payload=payload, want=want, want_mesh=want_mesh, want_val=want_val, ranks=ranks)


def _close_states(got, want, tol):
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), err_msg=k, **tol)


def _close_metrics(got, want, tol):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, err_msg=k, **tol)


def _close_step(got, want):
    metrics, gen, critic = got[:3]
    _close_metrics(metrics, want[0], METRIC_TOL)
    _close_states(gen, want[1], PARAM_TOL)
    _close_states(critic, want[2], PARAM_TOL)


def _close_grads(got, want):
    for k, w in want.items():
        torch.testing.assert_close(got[k], w, rtol=1e-4, atol=1e-5 * w.abs().max().item(), msg=k)


@pytest.mark.parametrize("key", [*JAX_CASES, PHANTOM])
def test_one_rank_2d_step_matches_jax(sp, key):
    """The port's one-rank 2D step on the same slices, at JAX's dp x sp
    tolerance (the reference the meshes are held to)."""
    _close_step(one_step(sp.payload["cases"][key], sp.payload["batches"][key]), sp.want[key])


@pytest.mark.parametrize("key", JAX_CASES)
@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_2d_dp_sp_step_matches_jax_single_device(sp, shape, key):
    for res in sp.ranks[shape]:
        _close_step(res["steps"][key], sp.want[key])


@pytest.mark.parametrize("key", JAX_CASES)
@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_2d_dp_sp_step_matches_jax_dp_sp_step(sp, shape, key):
    """Against JAX's own step on the same mesh shape (GSPMD's halo
    exchanges on the virtual CPU devices)."""
    for res in sp.ranks[shape]:
        _close_step(res["steps"][key], sp.want_mesh[shape, key])


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_2d_phantom_row_critic_matches_jax(sp, shape):
    """conf_2d's depth-3 critic on 32^2 slices: its last stride-2 block
    leaves 2 rows and its last conv 1 logit row, so ranks without rows
    compute a phantom one and keep none; the GP step's double backward
    runs through them. Against JAX's single-device step at every mesh,
    and JAX's own dp x sp step at (1, 2). At (2, 2) and (1, 4) JAX's
    GSPMD step, whose shards of 1 and 2 rows over 4 or 2 devices are
    padded, leaves its own single-device step (G by 2% in GP, critic
    parameters by 2e-3), beyond the tolerance it holds itself to; the
    port stays with the single-device step there."""
    critic = PatchGANDiscriminator(**DEEP_CRITIC)
    rows = [PHANTOM_PATCH[0]]
    for block in critic._blocks():
        rows.append(block.out_rows(rows[-1]))
    assert rows[-2:] == [2, 1]
    space = shape[1]
    assert any(hi == lo for lo, hi in (bounds(1, space, q) for q in range(space)))
    for res in sp.ranks[shape]:
        _close_step(res["steps"][PHANTOM], sp.want[PHANTOM])
        if shape == (1, 2):
            _close_step(res["steps"][PHANTOM], sp.want_mesh[shape, PHANTOM])


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_2d_dp_sp_step_with_the_options_matches_the_one_rank_step(sp, shape):
    """Instance norm, dropout and remat in the generator, layer norm and
    remat in the critic (its per-sample statistics summed over a slice's
    slabs), the port's own GP eps: the masks and the eps are drawn for the
    whole slices of the global batch on every rank."""
    want = one_step(sp.payload["cases"][OPTIONS], sp.payload["batches"][OPTIONS])
    for res in sp.ranks[shape]:
        got = res["steps"][OPTIONS]
        _close_step(got, want)
        _close_grads(got[3], want[3])


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_2d_dp_sp_device_augmentation_and_preview_match_the_one_rank_step(sp, shape):
    """The device 2D rotation and mirroring run on whole slices, then each
    rank keeps its slab: the step equals the one-rank step, and the
    preview re-derives the whole augmented batch (gathered) as one rank
    does."""
    want = augment_step(sp.payload["cases"][AUGMENT], sp.payload["batches"][AUGMENT])
    for res in sp.ranks[shape]:
        got = res["steps"][AUGMENT]
        _close_step(got, want)
        _close_grads(got[3], want[3])
        d = res["rank"] // shape[1]
        share = slice(d * 4 // shape[0], (d + 1) * 4 // shape[0])
        for name, g, w in zip(("scaled", "corrected", "attenuation", "mask"), got[4], want[4]):
            torch.testing.assert_close(g, w[share], rtol=1e-5, atol=1e-5, msg=name)


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_2d_every_rank_steps_with_the_same_gradients(sp, shape):
    ranks = sp.ranks[shape]
    for key in sp.payload["cases"]:
        first = ranks[0]["steps"][key]
        for res in ranks[1:]:
            for k, g in res["steps"][key][3].items():
                assert torch.equal(g, first[3][k]), (key, k)
            for a, b in zip(res["steps"][key][1:3], first[1:3]):
                assert all(torch.equal(a[k], b[k]) for k in a), key


@pytest.mark.parametrize("which", ["val", "val_512"])
@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_2d_dp_sp_val_steps_match_jax(sp, shape, which):
    """The val steps at (32, 16) and at 512^2 (256 rows a rank at (1, 2)),
    the corrected slices gathered whole."""
    opt, realism, zncc, sample_hat = sp.want_val[which]
    batch = sp.payload["val_batch" if which == "val" else "val_batch_512"]
    got_one = val(sp.payload["cases"][VAL], batch)
    n = len(batch)
    for got in [got_one, *(r[which] for r in sp.ranks[shape])]:
        np.testing.assert_allclose(got[:3], (opt, realism, zncc), rtol=1e-5, atol=1e-6)
    for res in sp.ranks[shape]:
        d = res["rank"] // shape[1]
        np.testing.assert_allclose(res[which][3][:, 0].numpy(), sample_hat[d * n // shape[0]:(d + 1) * n // shape[0]],
                                   rtol=1e-5, atol=1e-5)


class _FakeSpace:
    """Rank ``index`` of ``space`` without a process group: the halo
    exchange simulated on the ``whole`` tensor (see ``_halo_input``)."""

    def __init__(self, space, index, whole):
        self.space, self.space_index, self.whole = space, index, whole


def _halo_input(x, mesh, n, n_out, window, mode="zeros", dim=2):
    """``parallel/spatial.halo_input`` with the exchange's all-reduce summed
    here over every rank's writes (``_simulated_exchange``)."""
    windows = [window(o0, max(o1, o0 + 1)) for o0, o1 in (bounds(n_out, mesh.space, q) for q in range(mesh.space))]
    ext = _simulated_exchange(mesh.whole.movedim(dim, 0), n, mesh.space, windows, mode)[mesh.space_index]
    return ext.movedim(0, dim), bounds(n_out, mesh.space, mesh.space_index), windows[mesh.space_index][0]


@pytest.mark.parametrize("space", [2, 4])
@pytest.mark.parametrize("n,block", [
    (16, dict(in_channels=1, features=2, kernel_size=7, padding=3, padding_mode="reflect", norm=None)),  # the stem
    (16, dict(in_channels=2, features=3, kernel_size=3, stride=2, padding=1, norm=None)),  # a downsample
    (8, dict(in_channels=3, features=3, kernel_size=3, padding=1, padding_mode="reflect", norm=None)),  # ResNet
    (16, dict(in_channels=1, features=2, kernel_size=4, stride=2, padding=1, norm=None)),  # the critic's first
    (7, dict(in_channels=2, features=1, kernel_size=4, stride=1, padding=1, norm=None)),  # its last, unequal slabs
    (2, dict(in_channels=2, features=1, kernel_size=4, stride=1, padding=1, norm=None)),  # ranks without rows
    (8, dict(in_channels=3, features=2, kernel_size=3, stride=2, transpose=True, tconv_placement="same",
             norm=None)),
    (8, dict(in_channels=3, features=2, kernel_size=3, stride=2, transpose=True, tconv_placement="torch",
             norm=None)),
])
def test_2d_slab_convs_rebuild_the_whole_conv(monkeypatch, n, block, space):
    """float64, no process group: every rank's slab of a 2D conv block's
    output (``ConvBlock._conv_slab`` on the slab extended by the exchange
    plans' halo) equals its rows of the block's conv of the whole slice."""
    monkeypatch.setattr(blocks, "halo_input", _halo_input)
    torch.manual_seed(0)
    conv = ConvBlock(ndim=2, activation=None, dtype=torch.float64, **block).double()
    whole = torch.randn(2, block["in_channels"], n, 5, dtype=torch.float64)
    want = conv._conv(whole)
    n_out = conv.out_rows(n)
    assert want.shape[2] == n_out
    for q in range(space):
        lo, hi = bounds(n, space, q)
        conv.mesh = _FakeSpace(space, q, whole)
        got = conv._conv_slab(whole[:, :, lo:hi], n)
        o0, o1 = bounds(n_out, space, q)
        torch.testing.assert_close(got, want[:, :, o0:o1], rtol=1e-12, atol=1e-12)


OVERRIDE_2D_SP = '''
from dataclasses import replace


def config(base):
    return replace(base, name="tiny_conf_2d_sp", is_2d=True, train_patch_size=(32, 32), val_patch_size=(32, 32),
                   train_batch_size={0: 2, -1: 1, 1: 1}, val_batch_size={0: 2, -1: 1, 1: 1},
                   generator_args={**base.generator_args, "n_resnet_blocks": 1, "init_channels_out": 4, "ndim": 2},
                   critic_args={**base.critic_args, "init_channels_out": 4, "discriminator_depth": 2, "ndim": 2},
                   do_elastic=False, do_scale=False, do_rotation=True, rotation_deg=360.0, p_rotation=0.5,
                   augment_backend="device", compute_dtype="float32", num_workers=(1, 1), log_every=1,
                   validate_every=2, val_iterations=1, checkpoint_every=2, logger="file")
'''


def _cli_2d(tmp_path, fold):
    conf, splits = tmp_path / "tiny2d_sp.py", tmp_path / "splits.pkl"
    conf.write_text(OVERRIDE_2D_SP)
    splits.write_bytes(pickle.dumps({"train": [fold], "test": [fold]}))
    return lambda run_id: ["--conf", str(conf), "--cval-splits", str(splits), "--checkpoint-root",
                           str(tmp_path / "runs"), "--run-id", run_id, "--device", "cpu", "--iterations", "4"]


def _fold_2d(root):
    """Two patients per label, in-plane larger than the 32^2 slices."""
    from contrast_gan_3d_tpu_torch.data.preprocess import write_patient
    from tests.synth import synthetic_patient

    rng = np.random.default_rng(0)
    fold = []
    for label in (0, -1, 1):
        for i in range(2):
            vol, mask, _, meta = synthetic_patient(rng, (40, 36, 8))
            fold.append((str(write_patient(vol, mask, meta, f"p{label}_{i}", root)), label))
    return fold


def test_train_sp_devices_refuses_2d_slices_the_ranks_do_not_divide(tmp_path):
    """``--sp-devices 3`` on 32^2 slices: the first dim does not split over
    three ranks, refused before any rank starts (JAX's ``train.py``)."""
    args = _cli_2d(tmp_path, [("unused.npy", 0)])
    with pytest.raises(SystemExit, match=r"train_patch_size\[0\]=32 must be divisible by sp_devices=3"):
        train_cli.main(args("bad") + ["--sp-devices", "3"])


def test_train_sp_devices_2d_logs_the_one_rank_losses(tmp_path, monkeypatch):
    """``train --sp-devices 2`` on a tiny conf_2d override (the device 2D
    rotation and mirroring, weight clip, f32) starts two gloo ranks, each
    on its slab of the slices the one-rank run loads. Every logged train
    and validation loss is within JAX's dp x sp metric tolerance of the
    one-rank run's, and rank 0 writes the one-rank run's checkpoints."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    args = _cli_2d(tmp_path, _fold_2d(tmp_path / "patients"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as each of the two ranks runs
    try:
        one = train_cli.main(args("one"))
    finally:
        torch.set_num_threads(threads)
    assert one.runs[0].trainer.state.generator.ndim == 2
    assert train_cli.main(args("sp") + ["--sp-devices", "2"]) is None
    logged = {run: [json.loads(line) for line in (tmp_path / "runs" / run / "metrics" / "scalars.jsonl")
                    .read_text().splitlines()] for run in ("one", "sp")}
    assert [(r["stage"], r["iteration"]) for r in logged["sp"]] == [(r["stage"], r["iteration"]) for r in
                                                                     logged["one"]]
    assert {r["stage"] for r in logged["one"]} == {"train", "validation"}
    compared = set()
    for got, want in zip(logged["sp"], logged["one"]):
        losses = {k for k in want if k in ("D", "G", "G-full", "sim", "HU")}
        compared |= losses
        for k in losses:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=1e-5,
                                       err_msg=f"{want['stage']} {want['iteration']} {k}")
    assert compared == {"D", "G", "G-full", "sim", "HU"}
    assert sorted(p.name for p in (tmp_path / "runs" / "sp").glob("*.pt")) == \
        sorted(p.name for p in (tmp_path / "runs" / "one").glob("*.pt"))
