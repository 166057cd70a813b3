"""The port's augmentation vs the JAX package, on the CPU: the samplers, the
rotation matrix, the coordinate field and its elastic part, the batch
augmentation, a train step with augmentation on both sides, the preview,
and the host augmenter.

JAX draws from a PRNG key, which torch cannot reproduce, so the port is
fed JAX's draws rebuilt from the same key in the same split order
(``data/augment.py:50-88``: per sample ``split(key, 7)`` -> rotation,
rotation gate, scale, scale gate, elastic noise, elastic gate, elastic
magnitude). Tolerances, and why:
- samplers: 1e-5 of max|volume| (the same f32 blend); nearest exactly;
- coordinates: 1e-4 voxel (a 3x3 product and a separable resize summed
  in another order);
- the elastic field: 1e-6 (the same triangle weights, another order);
- augmented scans: 1e-4 of max|data| (coordinates 1e-5 voxel apart times
  the image gradient); masks equal wherever no coordinate lies within
  1e-4 of a half-integer;
- the train step: the train-step parity tolerances (losses 1e-4
  relative, Adam parameters within 2 lr);
- the host augmenter against the JAX one (its native warp): every voxel
  within 1 HU and at least 99.9% equal (float coordinates computed in
  another order round differently near .5).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrast_gan_3d_tpu import native
from contrast_gan_3d_tpu.data import augment as jax_aug
from contrast_gan_3d_tpu.data.host_augment import HostAugmenter as JaxHostAugmenter
from contrast_gan_3d_tpu.ops import resample as jax_rs
from contrast_gan_3d_tpu.trainer import steps as jax_steps
from contrast_gan_3d_tpu_torch.data import augment as aug
from contrast_gan_3d_tpu_torch.data.host_augment import HostAugmenter
from contrast_gan_3d_tpu_torch.ops import resample as rs
from contrast_gan_3d_tpu_torch.trainer.steps import StepConfig, build_preview_step, build_train_steps
from tests.test_torch_port_2d import jax_draws_2d
from tests.test_torch_port_train import Pair, assert_metrics_close, batches

ALWAYS = dict(p_elastic=1.0, p_scale=1.0, p_rotation=1.0)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def jax_draws(key, batch: int, cfg) -> aug.AugmentDraws:
    """The draws JAX's ``augment_batch(..., key, cfg)`` makes, as the port's
    ``AugmentDraws``."""
    rows = []
    for k in jax.random.split(key, batch):
        k_rot, k_rot_p, k_scale, k_scale_p, k_el, k_el_p, k_el_mag = jax.random.split(k, 7)
        g = cfg.elastic_grid
        rows.append((
            jax.random.bernoulli(k_rot_p, cfg.p_rotation),
            jax.random.uniform(k_rot, (3,), minval=-cfg.angle, maxval=cfg.angle),
            jax.random.bernoulli(k_scale_p, cfg.p_scale),
            jax.random.uniform(k_scale, (), minval=cfg.scale_range[0], maxval=cfg.scale_range[1]),
            jax.random.bernoulli(k_el_p, cfg.p_elastic),
            jax.random.uniform(k_el_mag, (), minval=cfg.deformation_scale[0], maxval=cfg.deformation_scale[1]),
            jax.random.uniform(k_el, (g, g, g, 3), minval=-1.0, maxval=1.0),
        ))
    cols = [np.stack([np.asarray(r[i]) for r in rows]) for i in range(7)]
    return aug.AugmentDraws(*(torch.from_numpy(c) for c in cols))


def configs(**kw):
    """The same augmentation config on both sides."""
    return jax_aug.AugmentConfig(**kw), aug.AugmentConfig(**kw)


def near_half(coords: torch.Tensor, tol=1e-4) -> torch.Tensor:
    """Voxels with a coordinate within ``tol`` of a half-integer."""
    frac = torch.remainder(coords, 1.0)
    return ((frac - 0.5).abs() < tol).any(-1)


# --- samplers ---------------------------------------------------------------


@pytest.mark.parametrize("channels", [None, 2])
def test_samplers_match_jax_with_deep_out_of_bounds_coordinates(rng, channels):
    shape = (2, 6, 7, 5) + ((channels,) if channels else ())
    vol = rng.normal(0, 100, shape).astype(np.float32)
    coords = rng.uniform(-12, 20, (2, 9, 4, 3)).astype(np.float32)
    coords[0, 0] = [-30.0, 3.5, 100.0]  # deep out of bounds on two axes
    got = rs.trilinear_sample(_t(vol), _t(coords)).numpy()
    want = np.stack([np.asarray(jax_rs.trilinear_sample(jnp.asarray(v), jnp.asarray(c))) for v, c in zip(vol, coords)])
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(vol).max())
    got_n = rs.nearest_sample(_t(vol), _t(coords)).numpy()
    want_n = np.stack([np.asarray(jax_rs.nearest_sample(jnp.asarray(v), jnp.asarray(c))) for v, c in zip(vol, coords)])
    np.testing.assert_array_equal(got_n, want_n)


def test_nearest_rounds_exact_half_integers_to_even():
    """The case ``F.grid_sample`` gets wrong: exact half-integers round half
    to even, as ``jnp.round`` and the native warp do."""
    vol = np.arange(8 * 8 * 8, dtype=np.float32).reshape(1, 8, 8, 8)
    half = np.array([[0.5, 1.5, 2.5], [3.5, 4.5, 6.5], [-0.5, 7.5, 5.5]], np.float32)[None]
    got = rs.nearest_sample(_t(vol), _t(half)).numpy()
    want = np.asarray(jax_rs.nearest_sample(jnp.asarray(vol[0]), jnp.asarray(half[0])))
    np.testing.assert_array_equal(got[0], want)
    ix = np.clip(np.round(half[0]).astype(int), 0, 7)  # numpy rounds half to even too
    np.testing.assert_array_equal(got[0], vol[0][ix[:, 0], ix[:, 1], ix[:, 2]])


def test_rotation_matrix_and_identity_grid_match_jax(rng):
    angles = rng.uniform(-np.pi, np.pi, (5, 3)).astype(np.float32)
    got = rs.rotation_matrix(_t(angles)).numpy()
    want = np.stack([np.asarray(jax_rs.rotation_matrix(jnp.asarray(a))) for a in angles])
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(rs.identity_grid((3, 4, 2)).numpy(), np.asarray(jax_rs.identity_grid((3, 4, 2))))


# --- the coordinate field ---------------------------------------------------


@pytest.mark.parametrize("shape", [(16, 16, 16), (13, 20, 9), (13, 20, 7), (16, 16, 4), (8, 8, 8)])
def test_elastic_field_is_jax_image_resize(rng, shape):
    """Upsampled axes, an unchanged axis and axes that shrink below the
    coarse grid (where ``jax.image.resize`` antialiases)."""
    coarse = rng.uniform(-1, 1, (2, 8, 8, 8, 3)).astype(np.float32)
    got = aug.elastic_field(_t(coarse), shape).numpy()
    want = np.stack([np.asarray(jax.image.resize(jnp.asarray(c), (*shape, 3), method="linear")) for c in coarse])
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("probs", [ALWAYS, {}])
@pytest.mark.parametrize("shape", [(16, 16, 16), (16, 12, 20)])
def test_coords_from_draws_match_jax_sample_coords(probs, shape):
    jcfg, cfg = configs(**probs)
    key = jax.random.key(3)
    draws = jax_draws(key, 4, jcfg)
    got = aug.coords_from_draws(draws, shape, cfg).numpy()
    want = np.stack([np.asarray(jax_aug._sample_coords(k, shape, jcfg)) for k in jax.random.split(key, 4)])
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_draw_is_reproducible_and_gated(rng):
    cfg = aug.AugmentConfig(p_rotation=0.5)
    a = aug.draw(torch.Generator().manual_seed(4), 64, cfg)
    b = aug.draw(torch.Generator().manual_seed(4), 64, cfg)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert 0 < int(a.rot_gate.sum()) < 64 and a.coarse.shape == (64, 8, 8, 8, 3)
    assert a.angles.abs().max() <= cfg.angle and a.scale.min() >= 0.7 and a.scale.max() <= 1.4
    # all gates off: the identity field
    off = a._replace(rot_gate=torch.zeros(64, dtype=torch.bool), scale_gate=torch.zeros(64, dtype=torch.bool),
                     elastic_gate=torch.zeros(64, dtype=torch.bool))
    coords = aug.coords_from_draws(off, (8, 8, 8), cfg)
    torch.testing.assert_close(coords, rs.identity_grid((8, 8, 8)).expand(64, 8, 8, 8, 3), rtol=0, atol=0)


@pytest.mark.parametrize("probs", [ALWAYS, dict(p_elastic=1.0, p_scale=0.0, p_rotation=0.0)])
def test_augment_batch_matches_jax(rng, probs):
    jcfg, cfg = configs(**probs)
    shape = (3, 16, 16, 16)
    data = rng.integers(-1024, 1500, shape).astype(np.float32)
    seg = (rng.random(shape) < 0.2).astype(np.float32)
    key = jax.random.key(5)
    want_d, want_s = jax_aug.augment_batch(jnp.asarray(data), jnp.asarray(seg), key, jcfg)
    draws = jax_draws(key, 3, jcfg)
    got_d, got_s = aug.augment_batch(_t(data), _t(seg), draws, cfg)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-4 * np.abs(data).max())
    safe = ~near_half(aug.coords_from_draws(draws, shape[1:], cfg))
    np.testing.assert_array_equal(got_s.numpy()[safe.numpy()], np.asarray(want_s)[safe.numpy()])
    assert safe.float().mean() > 0.99
    opt_only, none = aug.augment_batch(_t(data), None, draws, cfg)
    assert none is None
    torch.testing.assert_close(opt_only, got_d, rtol=0, atol=0)


def test_2d_batches_point_to_roadmap():
    """(B, X, Y) batches once raised here; they now take the 2D path
    (``Augment2DConfig``), which matches JAX's 2D ``augment_batch`` on the
    same draws (the full parity is in ``tests/test_torch_port_2d.py``)."""
    jcfg, cfg = jax_aug.Augment2DConfig(p_rotation=1.0, p_mirror=1.0), aug.Augment2DConfig(p_rotation=1.0, p_mirror=1.0)
    data = np.random.default_rng(0).normal(0, 100, (2, 8, 8)).astype(np.float32)
    key = jax.random.key(1)
    want, _ = jax_aug.augment_batch(jnp.asarray(data), jnp.asarray(data), key, jcfg)
    got, none = aug.augment_batch(_t(data), None, jax_draws_2d(key, 2, jcfg), cfg)
    assert none is None and got.shape == (2, 8, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5 * np.abs(data).max())


# --- the train step and the preview ----------------------------------------


class JaxKeyDraws:
    """The port's ``draw`` fed with JAX's: a step's first call gets the
    sub-optimal batch's draws (JAX's k2), the second the OPT batch's
    (k1), from the state key the JAX step splits (``steps.py:203, 319``)."""

    def __init__(self, rng_key, jcfg):
        _, k_aug, _ = jax.random.split(rng_key, 3)
        k1, k2 = jax.random.split(k_aug)
        self.keys, self.jcfg, self.calls = [k2, k1], jcfg, []

    def __call__(self, generator, batch, cfg):
        d = jax_draws(self.keys[len(self.calls)], batch, self.jcfg)
        self.calls.append(d)
        return d


def test_combined_step_with_augmentation_matches_jax():
    """A tiny f32 WC ``combined_step`` with every transform on, JAX's draws
    fed to the port: the losses, the BatchNorm statistics and the
    Adam-updated parameters at the train-step parity tolerances of
    ``tests/test_torch_port_train.py``."""
    pair = Pair("wc", seed=3)
    jcfg, cfg = configs(**ALWAYS)
    pair.jcfg = replace(pair.jcfg, augment=jcfg)
    pair.cfg = replace(pair.cfg, augment=cfg)
    (opt, sub, msk), = batches(21, mask_p=0.2)
    jsteps = jax_steps.build_train_steps(pair.jgen, pair.jcritic, pair.tx, pair.tx, pair.jcfg)
    draws = JaxKeyDraws(pair.jstate.rng, jcfg)
    pair.jstate, want = jsteps.combined_step(pair.jstate, opt, sub, msk)
    state, got = build_train_steps(pair.cfg, draw=draws).combined_step(pair.port_state(), opt, sub, msk)
    assert len(draws.calls) == 2 and draws.calls[0].angles.shape[0] == len(sub)
    assert_metrics_close(got, want)
    pair.check(state, 1)


def test_preview_is_the_batch_the_step_trained_on():
    """The preview, from the generator state saved before a step, equals the
    augmented and scaled sub-optimal batch and mask the step trained on."""
    pair = Pair("wc", seed=4)
    cfg = replace(pair.cfg, augment=aug.AugmentConfig(**ALWAYS))
    seen = []

    def recording_draw(generator, batch, c):
        d = aug.draw(generator, batch, c)
        seen.append(d)
        return d

    (opt, sub, msk), = batches(22, mask_p=0.2)
    state = pair.port_state()
    rng_before = state.rng.get_state()
    state, _ = build_train_steps(cfg, draw=recording_draw).critic_step(state, opt, sub, msk)
    want_sub, want_mask = aug.augment_batch(_t(sub), _t(msk), seen[0], cfg.augment)
    x, x_hat, atten, mask = build_preview_step(cfg)(state, rng_before, sub, msk)
    torch.testing.assert_close(x[:, 0], cfg.scaler(want_sub), rtol=0, atol=0)
    torch.testing.assert_close(mask[:, 0], want_mask, rtol=0, atol=0)
    torch.testing.assert_close(x_hat, x - atten, rtol=0, atol=0)
    assert state.generator.training and x.shape == (len(sub), 1, *sub.shape[1:])
    with pytest.raises(ValueError):
        build_preview_step(pair.cfg)


def test_step_config_takes_only_the_3d_augment_config():
    """The port's own configs (the 3D one and, since the 2D family,
    ``Augment2DConfig``); anything else, such as the JAX package's, raises."""
    assert StepConfig(augment=aug.AugmentConfig()).augment == aug.AugmentConfig()
    assert StepConfig(augment=aug.Augment2DConfig()).augment == aug.Augment2DConfig()
    for other in (jax_aug.AugmentConfig(), jax_aug.Augment2DConfig()):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            StepConfig(augment=other)


# --- the host augmenter -----------------------------------------------------


@pytest.mark.parametrize("shape", [(24, 20, 16), (9, 12, 7)])
def test_host_augmenter_matches_jax(rng, shape):
    """The same numpy seed gives the same transforms; the port's warp (its
    own samplers) against the JAX package's native warp, or its device
    path with the same draws where the native library is absent."""
    probs = dict(p_elastic=0.7, p_scale=0.7, p_rotation=0.7)
    jcfg, cfg = configs(**probs)
    jaug, paug = JaxHostAugmenter(jcfg, np.random.default_rng(6)), HostAugmenter(cfg, np.random.default_rng(6))
    x = np.linspace(-1, 1, shape[0])[:, None, None]
    base = (800 * np.sin(4 * x) * np.cos(np.linspace(0, 3, shape[1]))[None, :, None]
            + 100 * np.linspace(-1, 1, shape[2])[None, None, :])
    n_warped = n_voxels = n_equal = n_seg_equal = 0
    for i in range(10):
        scan = (base + rng.normal(0, 20, shape)).astype(np.int16)
        seg = (rng.random(shape) < 0.3).astype(np.int16)
        if native.has_native():
            want_scan, want_seg = jaug(scan, seg)
        else:
            with jaug._lock:
                affine, coarse, amp, any_t = jaug.sample_params(scan.shape)
            want_scan, want_seg = scan, seg
            if any_t:
                from tests.synth import centered_affine_coords

                coords = centered_affine_coords(shape, affine)
                if coarse is not None:
                    field = jax.image.resize(jnp.asarray(coarse), (*shape, 3), "linear")
                    coords = coords + field * jnp.asarray(amp)
                want_scan = np.floor(np.asarray(jax_rs.trilinear_sample(jnp.asarray(scan, jnp.float32), coords)) + 0.5)
                want_seg = np.asarray(jax_rs.nearest_sample(jnp.asarray(seg), coords))
        got_scan, got_seg = paug(scan, seg)
        assert got_scan.dtype == np.int16 and got_seg.dtype == np.int16
        np.testing.assert_array_equal(jaug.rng.bit_generator.state["state"]["state"],
                                      paug.rng.bit_generator.state["state"]["state"])
        assert np.abs(got_scan.astype(np.int32) - want_scan).max() <= 1
        n_warped += int(not np.array_equal(got_scan, scan))
        n_voxels += scan.size
        n_equal += int((got_scan == want_scan).sum())
        n_seg_equal += int((got_seg == want_seg).sum())
    assert n_warped >= 5
    assert n_equal / n_voxels >= 0.999, n_equal / n_voxels
    assert n_seg_equal / n_voxels >= 0.999, n_seg_equal / n_voxels


def test_host_augmenter_identity_when_no_gate_fires(rng):
    cfg = aug.AugmentConfig(p_elastic=0.0, p_scale=0.0, p_rotation=0.0)
    scan = rng.integers(-100, 100, (6, 6, 6)).astype(np.int16)
    seg = (rng.random((6, 6, 6)) < 0.5).astype(np.int16)
    got_scan, got_seg = HostAugmenter(cfg, np.random.default_rng(0))(scan, seg)
    assert got_scan is scan and got_seg is seg
