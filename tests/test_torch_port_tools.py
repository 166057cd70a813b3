"""The port's last tools against the JAX package's, on the CPU at tiny
widths (one ResNet block, 4-channel stems, 16^3 patches):

- ``import_torch_checkpoint``: a reference ``.pt`` written by JAX's
  ``utils/torch_port.save_reference_checkpoint`` goes through JAX's
  ``scripts/import_torch_checkpoint.main`` and the port's; the generators
  (through ``from_checkpoint``) and the critics (through
  ``load_checkpoint``) forward within 1e-5 of max|JAX| in f32; the step is
  the file's iteration, the optimizers hold no moments, the meta sidecar
  records the torch placement; a file without a critic leaves the critic
  initialised, with JAX's note;
- ``export_torch_checkpoint``: a port run exported and read by JAX's
  ``load_reference_checkpoint`` forwards within 1e-5 of the port; port ->
  ``.pt`` -> port is bit-equal (a JAX ``<step>.msgpack`` too);
  ``discriminator`` stays None; ``--no-critic`` writes no critic; the
  block-count flags cross-check;
- ``b96_probe``: the stage-prefix losses, and the gradients of the stem's
  and of the stage's own conv weight, against JAX's
  ``capture_intermediates`` prefix in the packed layout, within 1e-4 of
  max|JAX| (f32 sums in another order); both modes' JSON lines carry the
  JAX probe's names and keys;
- ``bench_host_augment`` prints one JSON object with the JAX tool's ten
  keys, and its logs go to stderr;
- ``utils/logging_utils``: ``project_logs_to_stderr`` keeps stdout free of
  log lines.
Every command defaults to the card and raises without one.
"""

import json
import logging
import runpy
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrast_gan_3d_tpu.models.discriminator import PatchGANDiscriminator as JaxCritic
from contrast_gan_3d_tpu.models.generator import ResnetGenerator as JaxGenerator
from contrast_gan_3d_tpu.trainer import checkpoint as jax_ckpt
from contrast_gan_3d_tpu.utils import torch_port as jax_torch_port
from contrast_gan_3d_tpu_torch import b96_probe, bench_host_augment, export_torch_checkpoint, import_torch_checkpoint
from contrast_gan_3d_tpu_torch.eval.corrector import CCTAContrastCorrector
from contrast_gan_3d_tpu_torch.models.discriminator import PatchGANDiscriminator
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.trainer import checkpoint as ckpt_lib
from contrast_gan_3d_tpu_torch.trainer.optim import make_optimizer
from contrast_gan_3d_tpu_torch.trainer.steps import init_state
from contrast_gan_3d_tpu_torch.utils import logging_utils
from contrast_gan_3d_tpu_torch.utils.reference_checkpoint import load_reference_checkpoint
from contrast_gan_3d_tpu_torch.utils.weights import critic_state_dict_from_jax, state_dict_from_jax
from tests.test_torch_port_models import _np_tree, randomize_norms

REPO = Path(__file__).resolve().parent.parent
GEN = dict(n_resnet_blocks=1, n_updownsample_blocks=2, init_channels_out=4)
CRITIC = dict(init_channels_out=4, discriminator_depth=2)
PATCH = (16, 16, 16)
# the JAX and the port commands' flags for GEN and CRITIC at PATCH
FLAGS = ["--n-resnet-blocks", "1", "--init-channels-out", "4", "--critic-init-channels", "4",
         "--discriminator-depth", "2", "--patch", *map(str, PATCH)]
FORWARD_TOL = 1e-5
PREFIX_TOL = 1e-4
# scripts/bench_host_augment.py:93-104
HOST_KEYS = {"warp_threads", "warp_ms_always_on", "augment_ms_effective", "crop_ms", "sustained_patches_per_sec",
             "consumption_patches_per_sec", "feeds_train_step", "warp2d_us_always_on",
             "sustained_2d_slices_per_sec", "feeds_2d_train_step"}


@pytest.fixture
def own_logging(monkeypatch):
    """The commands run in this process route the project's loggers to
    stderr and give their own loggers a handler: undo both, and every
    level set, after the test."""
    monkeypatch.setattr(logging_utils, "_DEFAULT_STREAM", "stdout")
    levels = {n: lg.level for n, lg in logging.root.manager.loggerDict.items() if isinstance(lg, logging.Logger)}
    yield
    for name in (b96_probe.LOGGER, bench_host_augment.LOGGER):
        logger = logging.getLogger(name)
        for h in list(logger.handlers):
            logger.removeHandler(h)
        logger.propagate = True
    for name, logger in logging.root.manager.loggerDict.items():
        if isinstance(logger, logging.Logger):
            logger.setLevel(levels.get(name, logging.NOTSET))


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (what, err, np.abs(want).max())


def _ncdhw(x):
    return torch.from_numpy(np.moveaxis(x, -1, 1).copy())


def _x(seed, b=2):
    return np.random.default_rng(seed).normal(0, 0.5, (b, *PATCH, 1)).astype(np.float32)


def _jax_variables(seed):
    """Seeded JAX generator (torch placement) and critic variables, their
    BatchNorms made non-trivial."""
    shape = (1, *PATCH, 1)
    gvars = JaxGenerator(**GEN, tconv_placement="torch").init(jax.random.key(seed), jnp.zeros(shape), train=False)
    cvars = JaxCritic(**CRITIC).init(jax.random.key(seed + 1), jnp.zeros(shape), train=False)
    return tuple(randomize_norms(_np_tree(v), np.random.default_rng(seed + i)) for i, v in enumerate((gvars, cvars)))


def _jax_forward(module, variables, x):
    return np.asarray(module.apply(variables, jnp.asarray(x), train=False))


def _port_forward(module, x):
    module.eval()
    with torch.no_grad():
        return np.moveaxis(module(_ncdhw(x)).numpy(), 1, -1)


def _jax_import(pt, out, monkeypatch):
    """JAX's ``scripts/import_torch_checkpoint.main``, in this process."""
    script = runpy.run_path(str(REPO / "scripts" / "import_torch_checkpoint.py"))
    monkeypatch.setattr(sys, "argv", ["import_torch_checkpoint.py", str(pt), str(out), *FLAGS])
    script["main"]()


def _port_state():
    """A fresh port train state of GEN and CRITIC on the CPU."""
    tx = lambda params: make_optimizer("adam", params)  # noqa: E731
    return init_state(ResnetGenerator(**GEN, tconv_placement="torch"), PatchGANDiscriminator(**CRITIC), tx, tx,
                      device="cpu")


@pytest.fixture(scope="module")
def reference_pt(tmp_path_factory):
    """(a reference .pt written by JAX from seeded variables, the
    variables)."""
    gvars, cvars = _jax_variables(11)
    pt = tmp_path_factory.mktemp("reference") / "700.pt"
    jax_torch_port.save_reference_checkpoint(pt, gvars, cvars, iteration=700)
    return pt, gvars, cvars


@pytest.fixture(scope="module")
def port_run(reference_pt, tmp_path_factory):
    """The port's import of ``reference_pt``: its run directory."""
    out = tmp_path_factory.mktemp("port_run")
    import_torch_checkpoint.main([str(reference_pt[0]), str(out), *FLAGS, "--device", "cpu"])
    return out


# --- import_torch_checkpoint -------------------------------------------------


def test_import_matches_jax_import(reference_pt, port_run, tmp_path, monkeypatch):
    pt, _, _ = reference_pt
    _jax_import(pt, tmp_path / "jax_run", monkeypatch)
    raw = jax_ckpt.load_checkpoint(tmp_path / "jax_run")
    assert int(raw["step"]) == 700
    for tree in (raw["gen_opt"], raw["critic_opt"]):  # optax's fresh Adam moments
        adam = next(p for p in tree.values() if "mu" in p)
        assert all(not np.any(leaf) for leaf in jax.tree.leaves((adam["mu"], adam["nu"])))
    x = _x(12)
    jgen = _jax_forward(JaxGenerator(**GEN, tconv_placement="torch"),
                        {"params": raw["gen_params"], "batch_stats": raw["gen_stats"]}, x)
    jcritic = _jax_forward(JaxCritic(**CRITIC), {"params": raw["critic_params"], "batch_stats": raw["critic_stats"]},
                           x)

    corrector = CCTAContrastCorrector.from_checkpoint(port_run, inference_patch_size=PATCH, device="cpu")
    assert corrector.generator.tconv_placement == "torch" and corrector.generator.norm == "batch"
    _close(_port_forward(corrector.generator, x), jgen, FORWARD_TOL, "generator")
    state = ckpt_lib.load_checkpoint(port_run, _port_state())
    assert state.step == 700
    _close(_port_forward(state.critic, x), jcritic, FORWARD_TOL, "critic")
    payload = torch.load(ckpt_lib.checkpoint_path(port_run, 700), weights_only=True)
    # torch's Adam holds no moments before its first step: they start at 0
    assert payload["gen_opt"]["state"] == {} and payload["critic_opt"]["state"] == {}
    assert "rng" not in payload
    for run in (port_run, tmp_path / "jax_run"):
        meta = json.loads((run / "700.meta.json").read_text())
        assert meta == {"generator": {"tconv_placement": "torch", "norm": "batch"}}


def test_import_without_critic_keeps_it_initialised(reference_pt, tmp_path, capsys):
    _, gvars, _ = reference_pt
    pt = tmp_path / "30.pt"
    jax_torch_port.save_reference_checkpoint(pt, gvars, iteration=30)
    import_torch_checkpoint.main([str(pt), str(tmp_path / "run"), *FLAGS, "--device", "cpu"])
    assert import_torch_checkpoint.NO_CRITIC_NOTE in capsys.readouterr().out
    critic = torch.load(tmp_path / "run" / "30.pt", weights_only=True)["critic"]
    assert critic.keys() == PatchGANDiscriminator(**CRITIC).state_dict().keys()
    # fresh BatchNorm statistics, finite flax-like initial weights
    assert all(torch.equal(v, torch.zeros_like(v)) for k, v in critic.items() if k.endswith("running_mean"))
    assert all(torch.equal(v, torch.ones_like(v)) for k, v in critic.items() if k.endswith("running_var"))
    assert all(torch.isfinite(v).all() for v in critic.values())


# --- export_torch_checkpoint -------------------------------------------------


def test_export_reads_in_jax_and_round_trips(port_run, tmp_path):
    out = tmp_path / "exported.pt"
    export_torch_checkpoint.main([str(port_run), str(out), "--device", "cpu"])
    state = ckpt_lib.load_checkpoint(port_run, _port_state())
    raw = torch.load(out, weights_only=True)
    assert raw["discriminator"] is None and raw["iteration"] == 700 and "critic_state_dict" in raw
    back = load_reference_checkpoint(out)
    for got, want in ((back["generator"], state.generator.state_dict()), (back["critic"], state.critic.state_dict())):
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in got)
    jax_back = jax_torch_port.load_reference_checkpoint(out)
    x = _x(13)
    _close(_jax_forward(JaxGenerator(**GEN, tconv_placement="torch"), jax_back["generator"], x),
           _port_forward(state.generator, x), FORWARD_TOL, "generator")
    _close(_jax_forward(JaxCritic(**CRITIC), jax_back["critic"], x), _port_forward(state.critic, x), FORWARD_TOL,
           "critic")


def test_export_options(port_run, reference_pt, tmp_path, monkeypatch):
    """``--no-critic``, ``--iteration``, the cross-checks, and a JAX run's
    ``<step>.msgpack`` as the input (bit-equal to its weights)."""
    out = tmp_path / "gen_only.pt"
    export_torch_checkpoint.main([str(port_run), str(out), "--iteration", "700", "--no-critic",
                                  "--n-resnet-blocks", "1", "--n-updownsample-blocks", "2", "--device", "cpu"])
    assert "critic_state_dict" not in torch.load(out, weights_only=True)
    with pytest.raises(ValueError, match="n_resnet_blocks"):
        export_torch_checkpoint.main([str(port_run), str(tmp_path / "x.pt"), "--n-resnet-blocks", "2",
                                      "--device", "cpu"])
    with pytest.raises(ValueError, match="discriminator_depth"):
        export_torch_checkpoint.main([str(port_run), str(tmp_path / "y.pt"), "--discriminator-depth", "3",
                                      "--device", "cpu"])
    _jax_import(reference_pt[0], tmp_path / "jax_run", monkeypatch)
    export_torch_checkpoint.main([str(tmp_path / "jax_run"), str(tmp_path / "from_jax.pt"), "--device", "cpu"])
    raw = jax_ckpt.load_checkpoint(tmp_path / "jax_run")
    back = load_reference_checkpoint(tmp_path / "from_jax.pt")
    want_gen = state_dict_from_jax({"params": raw["gen_params"], "batch_stats": raw["gen_stats"]})
    want_critic = critic_state_dict_from_jax({"params": raw["critic_params"], "batch_stats": raw["critic_stats"]})
    for got, want in ((back["generator"], want_gen), (back["critic"], want_critic)):
        assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in got)
    assert back["iteration"] == 700


# --- b96_probe ---------------------------------------------------------------


def test_stage_prefixes_match_jax_capture_intermediates():
    """Each stage's prefix loss sum(out**2) and its gradients over the stem's
    conv weight and the stage's own conv weight: the port's
    ``packed_prefix`` against JAX's packed generator with the stage's
    output captured, in train mode (batch statistics)."""
    jgen = JaxGenerator(**GEN, layout="packed")
    variables = randomize_norms(_np_tree(jgen.init(jax.random.key(3), jnp.zeros((1, *PATCH, 1)), train=False)),
                                np.random.default_rng(3))
    gen = ResnetGenerator(**GEN, layout="packed")
    gen.load_state_dict(state_dict_from_jax(variables), strict=True)
    gen.train()
    x = _x(4)
    own_conv = {"first": "first.conv.weight", "down_0": "down_0.conv.weight", "down_1": "down_1.conv.weight",
                "resnet_0": "resnet_0.block1.conv.weight", "up_1": "up_1.conv.weight", "up_0": "up_0.conv.weight",
                "last_conv": "last_conv.conv.weight"}
    assert gen.stage_names() == tuple(own_conv)

    def stage_outputs(params):
        _, mut = jgen.apply({"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x), train=True,
                            mutable=["batch_stats", "intermediates"],
                            capture_intermediates=lambda mdl, method: mdl.name in own_conv)
        return {k: v["__call__"][0].astype(jnp.float32) for k, v in mut["intermediates"].items()}

    @jax.jit
    def jax_prefixes(params):
        """Each stage's loss and its gradient: the gradient of sum(out_k**2)
        is the pull-back of 2 out_k alone (later stages do not reach
        out_k; JAX's probe lets XLA drop them)."""
        outs, pull = jax.vjp(stage_outputs, params)
        zeros = {k: jnp.zeros_like(v) for k, v in outs.items()}
        return {k: (jnp.sum(v**2), pull({**zeros, k: 2 * v})[0]) for k, v in outs.items()}

    prefixes = jax_prefixes(variables["params"])
    for stage, own in own_conv.items():
        loss, grads = prefixes[stage]
        want = state_dict_from_jax({"params": _np_tree(grads)})
        got = b96_probe.prefix_grads(gen, _ncdhw(x), stage)
        _close(got["loss"], loss, PREFIX_TOL, f"{stage} loss")
        for name in ("first.conv.weight", own):
            _close(got[name], want[name], PREFIX_TOL, f"{stage}: {name}")
        assert got["last_conv.conv.weight"] is None or stage == "last_conv"


@pytest.mark.parametrize("mode", ["--attrib", "--stages"])
def test_probe_lines(mode, capsys, own_logging):
    lines = b96_probe.main([mode, "--smoke", "--patch", *map(str, PATCH), "--n-opt", "2", "--n-sub", "2",
                            "--reps", "1", "--device", "cpu"])
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert out == lines
    if mode == "--attrib":
        assert [r["probe"] for r in out] == ["gen_forward_only", "critic_step", "generator_only_step",
                                             "combined_step"]
        assert all(r.keys() == {"probe", "sec", "batch", "patch"} and r["batch"] == [2, 2]
                   and r["patch"] == list(PATCH) for r in out)
    else:
        stages = ResnetGenerator(**b96_probe.SMOKE_GEN).stage_names()
        assert [r["probe"] for r in out] == [f"prefix_through_{s}" for s in stages]
        assert all(r.keys() == {"probe", "sec", "delta_vs_prev"} for r in out)
        assert out[0]["sec"] == out[0]["delta_vs_prev"]
    assert all(np.isfinite(r["sec"]) and r["sec"] > 0 for r in out)


# --- bench_host_augment, logging_utils and the device rule --------------------


def test_host_tool_prints_the_jax_keys_and_logs_to_stderr():
    res = subprocess.run([sys.executable, "-m", "contrast_gan_3d_tpu_torch.bench_host_augment", "--patch", "16",
                          "--reps", "1", "--device", "cpu"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    (line,) = res.stdout.splitlines()
    out = json.loads(line)
    assert out.keys() == HOST_KEYS
    assert out["consumption_patches_per_sec"] == pytest.approx(60 / 0.2802)
    assert out["sustained_patches_per_sec"] > 0 and out["warp_threads"] >= 1
    assert "host ceiling at 16^3" in res.stderr


def test_project_logs_to_stderr_keeps_stdout_clean(capsys, tmp_path, own_logging):
    names = [f"contrast_gan_3d_tpu_torch.tools_test_{i}" for i in range(3)]
    try:
        early = logging_utils.create_logger(names[0])
        logfile = logging.FileHandler(tmp_path / "x.log")
        early.addHandler(logfile)
        early.info("before")
        assert "before" in capsys.readouterr().out
        logging_utils.project_logs_to_stderr()
        late = logging_utils.create_logger(names[1])
        early.info("after")
        late.info("made after")
        captured = capsys.readouterr()
        assert captured.out == ""
        assert "after" in captured.err and "made after" in captured.err
        logfile.flush()
        assert "after" in (tmp_path / "x.log").read_text()  # a file handler keeps its file
        quiet = logging_utils.create_logger(names[2])
        logging_utils.set_project_loggers_level(logging.WARNING)
        assert all(logging.getLogger(n).level == logging.WARNING for n in names)
        quiet.info("dropped")
        assert capsys.readouterr().err == ""
    finally:
        for name in names:
            logger = logging.getLogger(name)
            for h in list(logger.handlers):
                logger.removeHandler(h)
                h.close()


@pytest.mark.parametrize("module,argv", [
    (import_torch_checkpoint, ["a.pt", "out"]),
    (export_torch_checkpoint, ["run", "b.pt"]),
    (bench_host_augment, []),
    (b96_probe, []),
], ids=["import", "export", "host", "probe"])
def test_commands_default_to_the_card(module, argv, own_logging):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cuda'"):
        module.main(argv)
