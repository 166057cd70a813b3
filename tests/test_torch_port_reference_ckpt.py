"""Reference ``<iteration>.pt`` checkpoints in the port
(``utils/reference_checkpoint.py``, ``CCTAContrastCorrector.
from_reference_checkpoint``, ``correct_scans --reference-pt``) against the
JAX package's ``utils/torch_port.py``, on the CPU.

Files go both ways: the JAX package writes and the port reads, the port
writes and the JAX package reads, for 2D and 3D generators (with
``tconv_placement="torch"``, the reference's window) and critics with
BatchNorm, no norm and LayerNorm. Each side's model then runs on the same
input. Tolerances: forwards 1e-4 of the output (f32 sums in another
order), corrections 0.1 HU per volume, as the corrector tests; the
weights themselves bit-identical (no arithmetic on the way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrast_gan_3d_tpu.eval.corrector import CCTAContrastCorrector as JaxCorrector
from contrast_gan_3d_tpu.models.discriminator import PatchGANDiscriminator as JaxCritic
from contrast_gan_3d_tpu.models.generator import ResnetGenerator as JaxGenerator
from contrast_gan_3d_tpu.utils import torch_port as jax_torch_port
from contrast_gan_3d_tpu_torch import correct_scans
from contrast_gan_3d_tpu_torch.eval.corrector import CCTAContrastCorrector
from contrast_gan_3d_tpu_torch.eval.utils import device_int16
from contrast_gan_3d_tpu_torch.models.discriminator import PatchGANDiscriminator
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.utils import io_utils
from contrast_gan_3d_tpu_torch.utils.reference_checkpoint import (
    critic_state_dict_to_reference,
    generator_state_dict_to_reference,
    load_reference_checkpoint,
    save_reference_checkpoint,
)
from contrast_gan_3d_tpu_torch.utils.weights import critic_state_dict_from_jax, generator_state_dict_from_jax
from tests.test_torch_port_models import _np_tree, randomize_norms

GEN = dict(n_resnet_blocks=2, n_updownsample_blocks=2, init_channels_out=4, tconv_placement="torch")
CRITIC = dict(init_channels_out=4, discriminator_depth=2)
SHAPES = {2: (32, 32), 3: (16, 16, 16)}


def _jax_pair(ndim, seed, critic_norm="batch"):
    """JAX generator and critic modules with randomized numpy variables."""
    shape = (1, *SHAPES[ndim], 1)
    jgen = JaxGenerator(**GEN, ndim=ndim)
    gvars = randomize_norms(_np_tree(jgen.init(jax.random.key(seed), jnp.zeros(shape), train=False)),
                            np.random.default_rng(seed))
    jcritic = JaxCritic(**CRITIC, ndim=ndim, norm=critic_norm)
    cvars = randomize_norms(_np_tree(jcritic.init(jax.random.key(seed + 1), jnp.zeros(shape), train=False)),
                            np.random.default_rng(seed + 1))
    return jgen, gvars, jcritic, cvars


def _channels_first(x):
    return torch.from_numpy(np.moveaxis(x, -1, 1).copy())


def _channels_last(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _forward_equal(jmod, jvars, pmod, x):
    want = np.asarray(jmod.apply(jvars, jnp.asarray(x), train=False))
    pmod.eval()
    with torch.no_grad():
        got = _channels_last(pmod(_channels_first(x)))
    np.testing.assert_allclose(got, want, atol=1e-4 * max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("critic_norm", ["batch", None, "layer"])
def test_jax_written_file_reads_in_the_port(tmp_path, ndim, critic_norm):
    """JAX's ``save_reference_checkpoint`` -> the port's loader
    (``weights_only=True``): the architecture, every weight, and the
    forwards of both networks."""
    jgen, gvars, jcritic, cvars = _jax_pair(ndim, 3, critic_norm)
    path = tmp_path / "1200.pt"
    jax_torch_port.save_reference_checkpoint(path, gvars, cvars, iteration=1200)
    loaded = load_reference_checkpoint(path)
    assert loaded["iteration"] == 1200
    assert loaded["generator_arch"] == dict(n_resnet_blocks=2, n_updownsample_blocks=2, init_channels_out=4,
                                            ndim=ndim)
    assert loaded["critic_arch"]["norm"] == critic_norm and loaded["critic_arch"]["ndim"] == ndim
    gen = ResnetGenerator(**loaded["generator_arch"], tconv_placement="torch")
    gen.load_state_dict(loaded["generator"], strict=True)
    critic = PatchGANDiscriminator(**loaded["critic_arch"])
    critic.load_state_dict(loaded["critic"], strict=True)
    for got, want in ((gen.state_dict(), generator_state_dict_from_jax(gvars)),
                      (critic.state_dict(), critic_state_dict_from_jax(cvars))):
        assert set(got) == set(want)
        for k in got:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    x = np.random.default_rng(4).normal(0, 0.5, (2, *SHAPES[ndim], 1)).astype(np.float32)
    _forward_equal(jgen, gvars, gen, x)
    _forward_equal(jcritic, cvars, critic, x)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("critic_norm", ["batch", "layer"])
def test_port_written_file_reads_in_jax(tmp_path, ndim, critic_norm):
    """The port's ``save_reference_checkpoint`` -> JAX's
    ``load_reference_checkpoint``: the reference layout (``discriminator``
    None, the critic under ``critic_state_dict``, BatchNorm counters), and
    the forwards of both networks."""
    jgen, gvars, jcritic, cvars = _jax_pair(ndim, 5, critic_norm)
    gen = ResnetGenerator(**GEN, ndim=ndim)
    gen.load_state_dict(generator_state_dict_from_jax(gvars), strict=True)
    critic = PatchGANDiscriminator(**CRITIC, ndim=ndim, norm=critic_norm)
    critic.load_state_dict(critic_state_dict_from_jax(cvars), strict=True)
    path = tmp_path / "7.pt"
    save_reference_checkpoint(path, gen.state_dict(), critic.state_dict(), iteration=7)
    raw = torch.load(path, map_location="cpu", weights_only=True)
    assert raw["discriminator"] is None and raw["iteration"] == 7
    assert set(raw["generator"]) == set(jax_torch_port.generator_state_dict_from_variables(gvars))
    assert set(raw["critic_state_dict"]) == set(jax_torch_port.critic_state_dict_from_variables(cvars))
    assert raw["generator"]["model.first.normalization.num_batches_tracked"].dtype == torch.int64
    back = jax_torch_port.load_reference_checkpoint(path)
    assert back["iteration"] == 7 and back["generator_arch"]["ndim"] == ndim
    x = np.random.default_rng(6).normal(0, 0.5, (2, *SHAPES[ndim], 1)).astype(np.float32)
    _forward_equal(jgen, back["generator"], gen, x)
    _forward_equal(jcritic, back["critic"], critic, x)


def test_port_round_trip_is_exact(tmp_path):
    gen, critic = ResnetGenerator(**GEN, ndim=2), PatchGANDiscriminator(**CRITIC, ndim=3, norm=None)
    save_reference_checkpoint(tmp_path / "a.pt", gen.state_dict(), critic.state_dict())
    loaded = load_reference_checkpoint(tmp_path / "a.pt")
    for got, want in ((loaded["generator"], gen.state_dict()), (loaded["critic"], critic.state_dict())):
        assert set(got) == set(want)
        for k in got:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    # a genuine reference file has no critic; the generator alone loads
    torch.save({"iteration": 3, "generator": generator_state_dict_to_reference(gen.state_dict()),
                "discriminator": None}, tmp_path / "b.pt")
    b = load_reference_checkpoint(tmp_path / "b.pt")
    assert b["critic"] is None and b["critic_arch"] is None and b["iteration"] == 3


@pytest.mark.parametrize("ndim", [2, 3])
def test_from_reference_checkpoint_matches_jax(tmp_path, ndim):
    """A JAX-written reference file corrects the same volume through the
    port's and JAX's ``from_reference_checkpoint`` within 0.1 HU, 3D in the
    direct layout; the port builds its generator with the torch
    transpose-conv placement."""
    _reference_correction_matches_jax(tmp_path, ndim, "direct" if ndim == 3 else "auto")


def test_from_reference_checkpoint_matches_jax_default_layout(tmp_path):
    """The same in both packages' default layout, packed for this 3D
    generator and window (the torch placement's one-voxel packed shift)."""
    _reference_correction_matches_jax(tmp_path, 3, "auto")


def _reference_correction_matches_jax(tmp_path, ndim, layout):
    _, gvars, _, _ = _jax_pair(ndim, 7)
    path = tmp_path / "100.pt"
    jax_torch_port.save_reference_checkpoint(path, gvars, iteration=100)
    patch = SHAPES[ndim]
    vol = np.random.default_rng(8).integers(-1024, 1500, (24, 24, 20) if ndim == 3 else (32, 32, 9)).astype(np.int16)
    kw = dict(inference_patch_size=patch, overlap=0.25, batch_size=2, layout=layout)
    want = np.asarray(JaxCorrector.from_reference_checkpoint(path, **kw)(vol))
    corrector = CCTAContrastCorrector.from_reference_checkpoint(path, device="cpu", **kw)
    assert corrector.generator.tconv_placement == "torch" and corrector.is_2d == (ndim == 2)
    assert corrector.packed == (ndim == 3 and layout == "auto")
    got = corrector(vol).numpy()
    assert np.abs(got - want).max() <= 0.1


@pytest.mark.parametrize("kw", [dict(n_resnet_blocks=3), dict(n_updownsample_blocks=1), dict(ndim=3),
                                dict(init_channels_out=8)])
def test_explicit_values_that_disagree_raise(tmp_path, kw):
    gen = ResnetGenerator(**GEN, ndim=2)
    save_reference_checkpoint(tmp_path / "c.pt", gen.state_dict())
    with pytest.raises(ValueError, match="does not match"):
        CCTAContrastCorrector.from_reference_checkpoint(tmp_path / "c.pt", inference_patch_size=(32, 32),
                                                        device="cpu", **kw)
    critic = PatchGANDiscriminator(**CRITIC, ndim=2)
    save_reference_checkpoint(tmp_path / "d.pt", gen.state_dict(), critic.state_dict())
    with pytest.raises(ValueError, match="discriminator_depth"):
        load_reference_checkpoint(tmp_path / "d.pt", discriminator_depth=3)


def test_critic_keys_follow_the_reference_names():
    sd = critic_state_dict_to_reference(PatchGANDiscriminator(**CRITIC).state_dict())
    assert {"model.first.conv.weight", "model.first.conv.bias", "model.middle.1.normalization.running_var",
            "model.middle.1.normalization.num_batches_tracked", "model.last.weight", "model.last.bias"} <= set(sd)
    gsd = generator_state_dict_to_reference(ResnetGenerator(**GEN).state_dict())
    # upsampling.0 is the widest transpose conv: the port's up_1
    assert gsd["model.upsampling.0.conv.weight"].shape == (16, 8, 3, 3, 3)
    assert {"model.resnet_backbone.1.block1.normalization.weight", "model.last_conv.bias"} <= set(gsd)


def test_correct_scans_reference_pt_equals_the_module_built_directly(tmp_path):
    """``correct_scans --reference-pt`` over a .mhd scan writes what the
    corrector built from the same file writes; ``--iteration`` is refused
    with it."""
    _, gvars, _, _ = _jax_pair(3, 9)
    path = tmp_path / "ref.pt"
    jax_torch_port.save_reference_checkpoint(path, gvars)
    vol = np.random.default_rng(10).integers(-1024, 1500, (24, 20, 18)).astype(np.int16)
    scan = tmp_path / "scan.mhd"
    io_utils.write_mhd(vol, scan, spacing=(0.5, 0.5, 0.5), origin=(0.0, 0.0, 0.0))
    written = correct_scans.main([str(path), str(tmp_path / "out"), str(scan), "--reference-pt", "--patch-size",
                                  "16", "16", "16", "--device", "cpu"])
    gen = ResnetGenerator(**GEN)
    gen.load_state_dict(generator_state_dict_from_jax(gvars), strict=True)
    # the command's defaults: layout "auto" (packed here) and its batch
    direct = CCTAContrastCorrector(gen, inference_patch_size=(16, 16, 16), device="cpu")
    assert direct.packed and direct.batch_size == 24
    np.testing.assert_array_equal(io_utils.read_image(written[0])[0], device_int16(direct(vol)).numpy())
    with pytest.raises(SystemExit):
        correct_scans.main([str(path), str(tmp_path / "out"), str(scan), "--reference-pt", "--iteration", "3",
                            "--device", "cpu"])
