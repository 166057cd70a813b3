"""Port ops vs the JAX package, on the CPU: space-to-depth, the block-conv
kernels' plain versions (B1, B2), B1's backward, the s2d wrapper (B3), the
scalers.

The JAX Pallas kernel runs in interpret mode, as tests/test_pallas_conv.py
runs it; the port's wrappers take their plain versions because the tensors
lie on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from contrast_gan_3d_tpu.data import scaler as jax_scaler
from contrast_gan_3d_tpu.ops import s2d_conv as jax_s2d
from contrast_gan_3d_tpu.ops.pallas_conv import block_conv3x3x3 as jax_block_conv
from contrast_gan_3d_tpu.ops.pallas_conv import block_conv3x3x3_v2 as jax_block_conv_v2
from contrast_gan_3d_tpu.ops.pallas_conv import s2d_conv3d_pallas
from contrast_gan_3d_tpu_torch.data import scaler as port_scaler
from contrast_gan_3d_tpu_torch.ops import s2d_conv as port_s2d
from contrast_gan_3d_tpu_torch.ops.block_conv import (
    BlockConv3x3x3Function,
    block_conv3x3x3,
    block_conv3x3x3_reference,
    block_conv3x3x3_v2,
    block_conv3x3x3_v2_reference,
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


def test_block_conv_v2_plain_matches_pallas_kernel(rng):
    """B2's plain version vs the Pallas kernel in interpret mode and XLA's
    conv, x (B, Z, Y, X, C) (tests/test_pallas_conv.py's v2 case).
    Tolerance 1e-4: f32 sums of 216 products of unit normals, in another
    order."""
    x = rng.normal(size=(2, 6, 7, 8, 8)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, 8, 4)).astype(np.float32)
    ref = jax.lax.conv_general_dilated(
        jnp.transpose(jnp.asarray(x), (0, 3, 2, 1, 4)), jnp.asarray(w), (1, 1, 1), "VALID",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
    )
    ref = np.asarray(jnp.transpose(ref, (0, 3, 2, 1, 4)))  # back to (B, Z, Y, X, C)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_block_conv_v2(jnp.asarray(x), jnp.asarray(w)))
    before = block_conv3x3x3_v2.launches
    got = block_conv3x3x3_v2(_t(x), _t(w))
    assert block_conv3x3x3_v2.launches == before
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 4, 5, 6, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    np.testing.assert_allclose(block_conv3x3x3_v2_reference(_t(x), _t(w)).numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("k_splits", [1, 2])
def test_block_conv_v2_plain_matches_pallas_k_splits(rng, k_splits):
    """The TPU kernel's channel split (k_splits 1 and 2 over 256 channels):
    the port reduces the whole K at once and must equal either. Tolerance
    1e-4 as above (6912 products per output)."""
    x = rng.normal(size=(1, 5, 5, 5, 256)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, 256, 4)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_block_conv_v2(jnp.asarray(x), jnp.asarray(w), k_splits=k_splits))
    got = block_conv3x3x3_v2(_t(x), _t(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_block_conv_v2_is_b1_with_x_and_y_swapped(rng):
    """B2 on (B, Z, Y, X, C) memory equals B1 on the same values laid out
    (B, Z, X, Y, C), with the same [qx, qy, qz] weights."""
    x = _t(rng.normal(size=(2, 5, 6, 7, 3)))  # (B, Z, Y, X, C)
    w = _t(rng.normal(size=(3, 3, 3, 3, 2)))
    got = block_conv3x3x3_v2(x, w)
    want = block_conv3x3x3(x.transpose(2, 3).contiguous(), w).transpose(2, 3)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


@pytest.mark.parametrize(
    "x_shape,w_shape",
    [((1, 6, 6, 6, 4), (3, 3, 3, 5, 2)), ((1, 6, 2, 6, 4), (3, 3, 3, 4, 2)), ((1, 6, 6, 6, 4), (2, 3, 3, 4, 2))],
)
def test_block_conv_v2_rejects_bad_shapes(x_shape, w_shape):
    with pytest.raises(ValueError):
        block_conv3x3x3_v2(torch.zeros(x_shape), torch.zeros(w_shape))


@pytest.mark.parametrize("wrapper,plain", [
    (block_conv3x3x3, block_conv3x3x3_reference),
    (block_conv3x3x3_v2, block_conv3x3x3_v2_reference),
])
@pytest.mark.parametrize("x_grad", [True, False])
def test_block_conv_backward_matches_autograd_of_plain(rng, wrapper, plain, x_grad):
    """BlockConv3x3x3Function's backward (dx as the same conv of padded dy
    with the flipped, transposed weight; dw as 27 per-tap products) vs
    autograd through the plain version, on non-cubic shapes so that a
    wrong tap or axis order shows. Tolerance 1e-5 of max|grad|: f32 sums
    in another order. Without x's gradient (the generator's stem, whose
    input is data) no dx is computed."""
    x_np = rng.normal(size=(2, 5, 6, 7, 3)).astype(np.float32)
    w_np = rng.normal(size=(3, 3, 3, 3, 4)).astype(np.float32)
    dy = _t(rng.normal(size=(2, 3, 4, 5, 4)))
    x, w = _t(x_np).requires_grad_(x_grad), _t(w_np).requires_grad_(True)
    out = wrapper(x, w)
    assert out.grad_fn is not None
    out.backward(dy)
    xr, wr = _t(x_np).requires_grad_(x_grad), _t(w_np).requires_grad_(True)
    plain(xr, wr).backward(dy)
    pairs = [(w.grad, wr.grad)] + ([(x.grad, xr.grad)] if x_grad else [])
    for got, want in pairs:
        scale = want.abs().max().item()
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5 * scale)
    assert (x.grad is None) == (not x_grad)


@pytest.mark.parametrize("layout", ["zxy", "zyx"])
def test_block_conv_bf16_backward_matches_plain_autograd(rng, layout):
    """The bf16 backward of ``BlockConv3x3x3Function`` on the CPU: dx and dw
    come back in bf16 and match autograd through the plain version in f32
    on the same bf16 values with dy rounded to bf16 (the backward's first
    rounding). Each result is then rounded once to bf16: tolerance 2^-8 of
    max|grad|, the most half a bf16 ulp can be."""
    x = _t(rng.normal(size=(2, 5, 6, 7, 3))).bfloat16().requires_grad_(True)
    w = _t(rng.normal(size=(3, 3, 3, 3, 4))).bfloat16().requires_grad_(True)
    dy = _t(rng.normal(size=(2, 3, 4, 5, 4)))
    out = BlockConv3x3x3Function.apply(x, w, layout)
    assert out.dtype == torch.float32
    out.backward(dy)
    assert x.grad.dtype == w.grad.dtype == torch.bfloat16
    xr, wr = x.detach().float().requires_grad_(True), w.detach().float().requires_grad_(True)
    (block_conv3x3x3_reference if layout == "zxy" else block_conv3x3x3_v2_reference)(xr, wr).backward(
        dy.bfloat16().float()
    )
    for got, want in ((x.grad, xr.grad), (w.grad, wr.grad)):
        scale = want.abs().max().item()
        np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=2.0**-8 * scale)


def test_s2d_block_is_differentiable_through_b1(rng):
    """B3 carries the gradient through B1's Function to x and w; the
    gradients match autograd through the plain s2d_conv3d. Tolerance 1e-4
    of max|grad| (343-tap sums, as the forward's 2e-4)."""
    x_np = rng.normal(size=(1, 8, 8, 8, 2)).astype(np.float32)
    w_np = rng.normal(size=(7, 7, 7, 2, 3)).astype(np.float32)
    b_np = rng.normal(size=(3,)).astype(np.float32)
    r = _t(rng.normal(size=(1, 8, 8, 8, 3)))
    grads = []
    for fn in (s2d_conv3d_block, port_s2d.s2d_conv3d):
        x, w, b = (_t(a).requires_grad_(True) for a in (x_np, w_np, b_np))
        (fn(x, w, b, f=4, padding_mode="reflect") * r).sum().backward()
        grads.append((x.grad, w.grad, b.grad))
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4 * want.abs().max().item())


@pytest.mark.parametrize(
    "x_shape,k,ci,co,mode,bias",
    [
        ((1, 8, 8, 8, 3), 7, 3, 2, "reflect", True),   # the generator's 7^3 stages
        ((1, 8, 8, 8, 2), 6, 2, 3, "zeros", False),    # even k: the d + f(K-1) bound
        ((2, 8, 12, 4, 1), 7, 1, 4, "reflect", False),  # stem-like, non-cubic
        ((1, 12, 8, 16, 2), 7, 2, 1, "zeros", True),   # projection-like, non-cubic
        ((1, 4, 16, 8, 1), 5, 1, 3, "reflect", True),  # odd k < 7, non-cubic
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
