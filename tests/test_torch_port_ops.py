"""Port ops vs the JAX package, on the CPU: space-to-depth, the block-conv
kernel's plain version (B1) and the s2d wrapper (B3), the scalers.

The JAX Pallas kernel runs in interpret mode, as tests/test_pallas_conv.py
runs it; the port's wrappers take their plain versions because the tensors
lie on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from contrast_gan_3d_tpu.data import scaler as jax_scaler
from contrast_gan_3d_tpu.ops import s2d_conv as jax_s2d
from contrast_gan_3d_tpu.ops.pallas_conv import block_conv3x3x3 as jax_block_conv
from contrast_gan_3d_tpu.ops.pallas_conv import s2d_conv3d_pallas
from contrast_gan_3d_tpu_torch.data import scaler as port_scaler
from contrast_gan_3d_tpu_torch.ops import s2d_conv as port_s2d
from contrast_gan_3d_tpu_torch.ops.block_conv import (
    block_conv3x3x3,
    block_conv3x3x3_reference,
    s2d_conv3d_block,
)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("shape,f", [((2, 8, 4, 12, 3), 4), ((1, 4, 6, 2, 5), 2)])
def test_space_to_depth_roundtrip_matches_jax(rng, shape, f):
    x = rng.normal(size=shape).astype(np.float32)
    s2d = port_s2d.space_to_depth(_t(x), f)
    np.testing.assert_array_equal(s2d.numpy(), np.asarray(jax_s2d.space_to_depth(jnp.asarray(x), f)))
    back = port_s2d.depth_to_space(s2d, f)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_s2d.depth_to_space(jnp.asarray(s2d.numpy()), f))
    )


@pytest.mark.parametrize("k,f,s", [(7, 4, 1), (6, 4, 1), (3, 4, 1), (3, 2, 2), (4, 2, 2)])
def test_transform_kernel_matches_jax_exactly(rng, k, f, s):
    w = rng.normal(size=(k, k, k, 2, 3)).astype(np.float32)
    got = port_s2d.transform_kernel(_t(w), f, s).numpy()
    want = np.asarray(jax_s2d.transform_kernel(jnp.asarray(w), f, s))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "shape,k,stride,mode",
    [((1, 8, 8, 8, 3), 7, 1, "reflect"), ((2, 8, 8, 4, 2), 3, 1, "zeros"), ((1, 8, 8, 8, 2), 4, 2, "zeros")],
)
def test_plain_s2d_conv3d_matches_jax(rng, shape, k, stride, mode):
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=(k, k, k, shape[-1], 2)).astype(np.float32)
    b = rng.normal(size=(2,)).astype(np.float32)
    want = jax_s2d.s2d_conv3d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), f=4 if stride == 1 else 2,
                              stride=stride, padding_mode=mode)
    got = port_s2d.s2d_conv3d(_t(x), _t(w), _t(b), f=4 if stride == 1 else 2, stride=stride,
                              padding_mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("x_shape,co", [((2, 6, 6, 6, 8), 4), ((1, 5, 5, 5, 256), 4)])
def test_block_conv_plain_matches_pallas_kernel(rng, x_shape, co):
    """B1's plain version (through the wrapper, CPU tensors) vs the Pallas
    kernel in interpret mode; the second shape is the k_splits case."""
    x = rng.normal(size=x_shape).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, x_shape[-1], co)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_block_conv(jnp.asarray(x), jnp.asarray(w)))
    before = block_conv3x3x3.launches
    got = block_conv3x3x3(_t(x), _t(w))
    assert block_conv3x3x3.launches == before  # the CPU never counts a launch
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    np.testing.assert_allclose(block_conv3x3x3_reference(_t(x), _t(w)).numpy(), want, atol=1e-4)


def test_block_conv_plain_takes_bf16(rng):
    """bf16 inputs are widened and contracted in f32, f32 out."""
    x = torch.from_numpy(rng.normal(size=(1, 5, 4, 6, 8)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.normal(size=(3, 3, 3, 8, 3)).astype(np.float32)).bfloat16()
    got = block_conv3x3x3(x, w)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), block_conv3x3x3(x.float(), w.float()).numpy(), atol=1e-5)


@pytest.mark.parametrize(
    "x_shape,w_shape",
    [((1, 6, 6, 6, 4), (3, 3, 3, 5, 2)), ((1, 2, 6, 6, 4), (3, 3, 3, 4, 2)), ((6, 6, 6, 4), (3, 3, 3, 4, 2))],
)
def test_block_conv_rejects_bad_shapes(x_shape, w_shape):
    with pytest.raises(ValueError):
        block_conv3x3x3(torch.zeros(x_shape), torch.zeros(w_shape))


@pytest.mark.parametrize(
    "x_shape,k,ci,co,mode,bias",
    [
        ((1, 8, 8, 8, 3), 7, 3, 2, "reflect", True),   # the generator's 7^3 stages
        ((1, 8, 8, 8, 2), 6, 2, 3, "zeros", False),    # even k: the d + f(K-1) bound
        ((2, 8, 12, 4, 1), 7, 1, 4, "reflect", False),  # stem-like, non-cubic
    ],
)
def test_s2d_block_matches_pallas_wrapper_and_xla(rng, x_shape, k, ci, co, mode, bias):
    x = rng.normal(size=x_shape).astype(np.float32)
    w = rng.normal(size=(k, k, k, ci, co)).astype(np.float32)
    b = rng.normal(size=(co,)).astype(np.float32) if bias else None
    jb = None if b is None else jnp.asarray(b)
    with pltpu.force_tpu_interpret_mode():
        want_pallas = np.asarray(s2d_conv3d_pallas(jnp.asarray(x), jnp.asarray(w), jb, f=4, padding_mode=mode))
    want_xla = np.asarray(jax_s2d.s2d_conv3d(jnp.asarray(x), jnp.asarray(w), jb, f=4, padding_mode=mode))
    got = s2d_conv3d_block(_t(x), _t(w), None if b is None else _t(b), f=4, padding_mode=mode)
    assert tuple(got.shape) == want_xla.shape == x_shape[:4] + (co,)
    np.testing.assert_allclose(got.numpy(), want_pallas, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), want_xla, atol=2e-4)


def test_s2d_block_falls_back_for_unsupported(rng):
    """K=2 block kernels (3^3 at f=4) and dims that do not divide f take the
    plain s2d_conv3d path, as the JAX wrapper does."""
    x = rng.normal(size=(1, 8, 8, 8, 2)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, 2, 2)).astype(np.float32)
    want = np.asarray(s2d_conv3d_pallas(jnp.asarray(x), jnp.asarray(w), f=4))
    before = s2d_conv3d_block.launches
    got = s2d_conv3d_block(_t(x), _t(w), f=4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), port_s2d.s2d_conv3d(_t(x), _t(w), f=4).numpy(), atol=0)
    assert s2d_conv3d_block.launches == before


def test_s2d_block_rejects_unknown_padding_mode(rng):
    x = _t(rng.normal(size=(1, 8, 8, 8, 1)))
    w = _t(rng.normal(size=(7, 7, 7, 1, 2)))
    with pytest.raises(ValueError, match="padding_mode"):
        s2d_conv3d_block(x, w, f=4, padding_mode="reflekt")
    with pytest.raises(ValueError, match="padding_mode"):
        s2d_conv3d_pallas(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), f=4, padding_mode="reflekt")


@pytest.mark.parametrize("name", ["Scaler", "ZeroCenterScaler", "FactorZeroCenterScaler"])
def test_scalers_match_jax(name):
    vals = np.array([-1024, -238, 0, 238, 600, 1500], np.float32)
    port, ref = getattr(port_scaler, name)(), getattr(jax_scaler, name)()
    got = port(torch.from_numpy(vals))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref(jnp.asarray(vals))), rtol=1e-6)
    np.testing.assert_allclose(port.unscale(got).numpy(), vals, atol=1e-3)
    if name != "Scaler":
        assert port.shift == ref.shift == 238
