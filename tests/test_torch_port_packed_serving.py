"""The packed layout on the port's serving and training entry points, on
the CPU, against the JAX package: the packed sliding window (aligned and
unaligned volumes), ``CCTAContrastCorrector``'s ``layout`` and
``batch_size`` defaults resolved as JAX resolves them, the refusals, and
``experiments/builder``'s ``generator_layout="auto"`` (mirrors ``tests/
test_builder_policies.py``). Tolerance: 0.1 HU per corrected volume."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrast_gan_3d_tpu.eval.corrector import CCTAContrastCorrector as JaxCorrector
from contrast_gan_3d_tpu.experiments import config as jax_config
from contrast_gan_3d_tpu.experiments.builder import build as jax_build
from contrast_gan_3d_tpu.models.generator import ResnetGenerator as JaxGenerator
from contrast_gan_3d_tpu.ops import sliding_window as jax_sw
from contrast_gan_3d_tpu_torch.eval.corrector import CCTAContrastCorrector
from contrast_gan_3d_tpu_torch.experiments import builder, config
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.ops import sliding_window as port_sw
from tests.test_torch_port_models import TINY, carried_generator

HU_TOL = 0.1
PATCH = (16, 16, 16)


@pytest.fixture(scope="module")
def carried():
    return carried_generator(TINY, 11)


def _vol(seed, shape):
    return np.random.default_rng(seed).integers(-1024, 1500, shape).astype(np.int16)


@pytest.mark.parametrize("shape,overlap", [((24, 20, 16), 0.5), ((22, 19, 14), 0.25)],
                         ids=["aligned", "unaligned"])
def test_packed_window_matches_jax(carried, shape, overlap):
    """``make_volume_corrector(packed_io=True)`` around the packed forward,
    port against JAX, on a block-aligned volume and on one the packed
    window must edge-pad (22, 19, 14 -> 24, 20, 16), batch 2 with a
    remainder."""
    jgen, variables, tgen = carried
    vol = _vol(4, shape)
    jp = JaxGenerator(**TINY, layout="packed", packed_input=True, packed_output=True)
    want = np.asarray(jax_sw.make_volume_corrector(
        lambda p: jp.apply(variables, p, train=False), patch_size=PATCH, overlap=overlap, batch_size=2,
        packed_io=True)(jnp.asarray(vol, jnp.float32)))
    tgen.eval()
    correct = port_sw.make_volume_corrector(
        lambda p: tgen.forward_packed(p, packed_input=True, packed_output=True), patch_size=PATCH,
        overlap=overlap, batch_size=2, device="cpu", packed_io=True)
    with torch.no_grad():
        got = correct(vol)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert np.abs(got.numpy() - want).max() <= HU_TOL


def test_default_correction_is_jax_default_for_unaligned_scans(carried):
    """The fault this layout closes: with default arguments, a (24, 20, 18)
    scan at overlap 0.45 (stride 9 direct, 8 packed; z padded to 20) is
    corrected as JAX's default corrector corrects it, which differs from
    the port's direct layout by more than the tolerance."""
    jgen, variables, tgen = carried
    vol = _vol(5, (24, 20, 18))
    kw = dict(inference_patch_size=PATCH, overlap=0.45)
    want = np.asarray(JaxCorrector(jgen, variables["params"], variables["batch_stats"], **kw)(vol))
    corrector = CCTAContrastCorrector(tgen, device="cpu", **kw)
    assert corrector.packed and corrector.batch_size == 24
    got = corrector(vol).numpy()
    assert np.abs(got - want).max() <= HU_TOL
    direct = CCTAContrastCorrector(tgen, device="cpu", layout="direct", **kw)
    assert not direct.packed and direct.batch_size == 8
    assert np.abs(direct(vol).numpy() - got).max() > HU_TOL


@pytest.mark.parametrize("kw,packed", [
    (dict(), True), (dict(layout="direct"), False), (dict(overlap=0.8), False),
    (dict(inference_patch_size=(16, 16, 10)), False), (dict(inference_patch_size=(4, 8, 8)), False),
])
def test_layout_auto_resolves_as_jax(carried, kw, packed):
    """The eligibility test and the batch default (24 packed, 8 direct) of
    JAX's corrector: stride >= 4, patch dims a multiple of max(4, 2^n) and
    at least 8."""
    jgen, variables, tgen = carried
    kw = dict(dict(inference_patch_size=PATCH, overlap=0.5), **kw)
    jcorr = JaxCorrector(jgen, variables["params"], variables["batch_stats"], **kw)
    corrector = CCTAContrastCorrector(tgen, device="cpu", **kw)
    assert corrector.packed == jcorr._packed == packed
    assert corrector.batch_size == jcorr.batch_size == (24 if packed else 8)


@pytest.mark.parametrize("kw", [dict(overlap=0.8), dict(inference_patch_size=(16, 16, 10))])
def test_packed_layout_refused_where_not_eligible(carried, kw):
    """``layout="packed"`` raises where "auto" would fall back, as in JAX;
    the window alone refuses a stride under 4."""
    jgen, variables, tgen = carried
    kw = dict(dict(inference_patch_size=PATCH, overlap=0.5, layout="packed"), **kw)
    with pytest.raises(ValueError, match="unsupported"):
        JaxCorrector(jgen, variables["params"], variables["batch_stats"], **kw)
    with pytest.raises(ValueError, match="unsupported"):
        CCTAContrastCorrector(tgen, device="cpu", **kw)
    with pytest.raises(ValueError, match="stride >= 4"):
        port_sw.make_volume_corrector(lambda x: x, patch_size=PATCH, overlap=0.9, device="cpu", packed_io=True)


def test_corrector_rejects_a_preconfigured_packed_generator():
    gen = ResnetGenerator(**TINY, layout="packed", packed_input=True, packed_output=True)
    with pytest.raises(ValueError, match="plain full-resolution"):
        CCTAContrastCorrector(gen, inference_patch_size=PATCH, device="cpu")
    # a generator built packed (plain I/O) is served like a direct one
    assert CCTAContrastCorrector(ResnetGenerator(**TINY, layout="packed"), inference_patch_size=PATCH,
                                 device="cpu").packed


def test_packed_corrector_in_bf16_rounds_the_packed_volume(carried):
    """bf16 serving packs the volume once in bf16 and blends in f32: the
    packed bf16 correction stays within a bf16 rounding of the f32 one
    (2^-8 of the scaled range, times the 1500 HU span, per voxel), and is
    not equal to it."""
    _, _, tgen = carried
    vol = _vol(6, (24, 20, 16))
    kw = dict(inference_patch_size=PATCH, overlap=0.5, device="cpu")
    f32 = CCTAContrastCorrector(tgen, **kw)(vol)
    b16 = CCTAContrastCorrector(tgen, dtype=torch.bfloat16, **kw)(vol)
    err = (b16 - f32).abs().max().item()
    assert 0 < err <= 2.0**-8 * 2500


# --- the builder ------------------------------------------------------------


def _layouts(name, **change):
    cfg = dataclasses.replace(config.PRESETS[name](), logger="none", **change)
    jcfg = dataclasses.replace(jax_config.PRESETS[name](), logger="none", **change)
    return builder.build(cfg, device="cpu").generator.layout, jax_build(jcfg).generator.layout


@pytest.mark.parametrize("name,change,want", [
    ("basic_3d", {}, "packed"),
    ("small_patch", {}, "packed"),
    ("conf_2d", {}, "direct"),
    ("basic_3d", dict(generator_layout="direct"), "direct"),
    ("basic_3d", dict(train_patch_size=(126, 126, 126)), "direct"),
    ("basic_3d", dict(generator_args={"n_resnet_blocks": 2, "n_updownsample_blocks": 0, "init_channels_out": 4}),
     "direct"),
    ("basic_3d", dict(generator_args={"n_resnet_blocks": 1, "n_updownsample_blocks": 2, "init_channels_out": 4,
                                      "layout": "direct"}), "direct"),
    ("basic_3d", dict(generator_layout="direct", generator_args={"n_resnet_blocks": 1, "n_updownsample_blocks": 2,
                                                                 "init_channels_out": 4, "layout": "packed"}),
     "packed"),
])
def test_builder_layout_auto_resolves_as_jax(name, change, want):
    """``basic_3d`` and ``small_patch`` pack; ``conf_2d``, unaligned
    patches and ``n_updownsample_blocks=0`` stay direct; an explicit
    ``generator_args["layout"]`` wins over ``generator_layout``."""
    assert _layouts(name, **change) == (want, want)


def test_packed_builder_generator_trains_like_direct():
    """The built packed generator holds the direct layout's parameters;
    one train-mode forward of both from one state agrees within the
    layouts' 2e-4 and updates the same running statistics."""
    cfg = dataclasses.replace(config.basic_3d(), logger="none", compute_dtype="float32",
                              generator_args={"n_resnet_blocks": 1, "n_updownsample_blocks": 2,
                                              "init_channels_out": 4})
    packed = builder.build(cfg, device="cpu").generator
    direct = builder.build(dataclasses.replace(cfg, generator_layout="direct"), device="cpu").generator
    assert packed.layout == "packed" and direct.layout == "direct"
    for (k, a), b in zip(packed.state_dict().items(), direct.state_dict().values()):
        assert torch.equal(a, b), k
    x = torch.from_numpy(np.random.default_rng(3).normal(0, 0.5, (2, 1, 16, 16, 16)).astype(np.float32))
    assert (packed.train()(x) - direct.train()(x)).abs().max() <= 2e-4
    for (k, a), b in zip(packed.state_dict().items(), direct.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6, msg=k)
