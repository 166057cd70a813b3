"""The port's block-space ("packed") ops against the JAX package's, on
the CPU: ``ops/packed.py`` and ``ops/s2d_conv.d2s_tconv3d``. Mirrors the
op tests of ``tests/test_packed.py`` (the generator's are in
``tests/test_torch_port_packed_generator.py``).

Tolerance: within 1e-4 of max|JAX| (the reflect pad, the transformed
kernels and the repacks are exact copies: 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrast_gan_3d_tpu.ops import packed as jax_packed
from contrast_gan_3d_tpu.ops import s2d_conv as jax_s2d
from contrast_gan_3d_tpu_torch.ops import packed
from contrast_gan_3d_tpu_torch.ops import s2d_conv as port_s2d

OP_TOL = 1e-4


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want, tol=OP_TOL, what=""):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), (what, np.abs(got - want).max())


# --- ops ----------------------------------------------------------------------


@pytest.mark.parametrize(
    "k,stride,pad,f_in,f_out,ci,co,dim",
    [
        (3, 1, 1, 2, 2, 4, 8, 8),     # stem-like stride-1
        (7, 1, 3, 2, 2, 1, 16, 16),   # the stem's shape
        (3, 2, 1, 2, 2, 4, 8, 16),    # a downsample, packed out
        (3, 2, 1, 2, 1, 4, 8, 16),    # the last downsample, unpacked out
        (7, 1, 3, 2, 4, 16, 1, 16),   # the projection: f2 in, f4 out
        (3, 1, 1, 4, 4, 2, 3, 8),     # f4 pipeline
        (3, 2, 1, 4, 2, 2, 3, 16),    # f4 in, f2 out, stride 2
    ],
)
def test_packed_conv_zero_pad_matches_jax(k, stride, pad, f_in, f_out, ci, co, dim):
    rng = np.random.default_rng(k * 1000 + stride * 100 + f_in * 10 + f_out + dim)
    x = rng.standard_normal((2, dim, dim, dim, ci)).astype(np.float32)
    w = rng.standard_normal((k, k, k, ci, co)).astype(np.float32)
    ob = (dim // stride // f_out,) * 3
    want = jax_packed.packed_conv3d(jax_s2d.space_to_depth(jnp.asarray(x), f_in), jnp.asarray(w), f_in=f_in,
                                    f_out=f_out, stride=stride, pad=pad, out_blocks=ob)
    got = packed.packed_conv3d(port_s2d.space_to_depth(_t(x), f_in), _t(w), f_in=f_in, f_out=f_out,
                               stride=stride, pad=pad, out_blocks=ob)
    _close(got, want)


def test_packed_conv_bias_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 8, 8, 8, 2)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 2, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    kw = dict(f_in=2, f_out=2, stride=1, pad=1, out_blocks=(4, 4, 4))
    want = jax_packed.packed_conv3d(jax_s2d.space_to_depth(jnp.asarray(x), 2), jnp.asarray(w), jnp.asarray(b), **kw)
    got = packed.packed_conv3d(port_s2d.space_to_depth(_t(x), 2), _t(w), _t(b), **kw)
    _close(got, want)


@pytest.mark.parametrize("f,p,dim", [(2, 3, 8), (2, 1, 8), (4, 3, 16), (2, 4, 12)])
def test_reflect_pad_packed_matches_jax(f, p, dim):
    """An exact copy of JAX's packed reflect pad, whose unpacked form is a
    full-resolution reflect pad of ceil(p/f)*f voxels."""
    x = np.random.default_rng(f * 100 + p).standard_normal((2, dim, dim, dim, 3)).astype(np.float32)
    want, o_want = jax_packed.reflect_pad_packed(jax_s2d.space_to_depth(jnp.asarray(x), f), f, p)
    got, o = packed.reflect_pad_packed(port_s2d.space_to_depth(_t(x), f), f, p)
    assert o == o_want == -(-p // f) * f - p
    _close(got, want, 0)
    L = -(-p // f) * f
    full = port_s2d.reflect_pad(_t(x), [(L, L)] * 3, dims=(1, 2, 3))
    assert torch.equal(port_s2d.depth_to_space(got, f), full)


@pytest.mark.parametrize("k,pad,f,ci,co,dim", [(7, 3, 2, 2, 3, 16), (7, 3, 4, 16, 1, 16)])
def test_packed_conv_reflect_matches_jax(k, pad, f, ci, co, dim):
    """reflect_pad_packed + the offset conv (the stem / projection)."""
    rng = np.random.default_rng(k + f)
    x = rng.standard_normal((1, dim, dim, dim, ci)).astype(np.float32)
    w = rng.standard_normal((k, k, k, ci, co)).astype(np.float32)
    f_out = 4 if co == 1 else f
    ob = (dim // f_out,) * 3
    xp, o = jax_packed.reflect_pad_packed(jax_s2d.space_to_depth(jnp.asarray(x), f), f, pad)
    want = jax_packed.packed_conv3d(xp, jnp.asarray(w), f_in=f, f_out=f_out, o=(o,) * 3, out_blocks=ob)
    xp, o = packed.reflect_pad_packed(port_s2d.space_to_depth(_t(x), f), f, pad)
    got = packed.packed_conv3d(xp, _t(w), f_in=f, f_out=f_out, o=(o,) * 3, out_blocks=ob)
    _close(got, want)


def _tconv_inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 6, 6, 6, 4)).astype(np.float32),
            rng.standard_normal((3, 3, 3, 4, 5)).astype(np.float32),
            rng.standard_normal(5).astype(np.float32))


@pytest.mark.parametrize("convention", ["same", "torch"])
@pytest.mark.parametrize("name", ["packed_tconv3d", "packed_tconv3d_f4"])
def test_packed_tconv_matches_jax(name, convention):
    x, w, b = _tconv_inputs(7)
    want = getattr(jax_packed, name)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), convention=convention)
    got = getattr(packed, name)(_t(x), _t(w), _t(b), convention=convention)
    _close(got, want)
    # unpacked, the packed transpose conv is the d2s one
    f = 2 if name == "packed_tconv3d" else 4
    d2s = port_s2d.d2s_tconv3d(_t(x), _t(w), _t(b), convention=convention)
    _close(port_s2d.depth_to_space(got, f), d2s.detach().numpy())


@pytest.mark.parametrize("convention", ["same", "torch"])
def test_d2s_tconv3d_matches_jax(convention):
    x, w, b = _tconv_inputs(8)
    want = jax_s2d.d2s_tconv3d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), convention=convention)
    _close(port_s2d.d2s_tconv3d(_t(x), _t(w), _t(b), convention=convention), want)
    np.testing.assert_array_equal(port_s2d._tconv_axis_map(3, 2), jax_s2d._tconv_axis_map(3, 2))
    shift = int(convention == "torch")
    np.testing.assert_array_equal(packed._tconv_phase_map_tensor(3, 2, 2, shift, torch.float32, "cpu").numpy(),
                                  jax_packed._tconv_f4_axis_map(3, 2, convention == "torch"))


@pytest.mark.parametrize("k,s", [(5, 2), (3, 1), (4, 2)])
def test_tconv_axis_map_refuses_other_windows(k, s):
    with pytest.raises(NotImplementedError, match="kernel 3 stride 2"):
        jax_s2d._tconv_axis_map(k, s)
    with pytest.raises(NotImplementedError, match="kernel 3 stride 2"):
        port_s2d._tconv_axis_map(k, s)
    with pytest.raises(NotImplementedError, match="kernel 3 stride 2"):
        port_s2d.d2s_tconv3d(torch.zeros(1, 2, 2, 2, 1), torch.zeros(k, k, k, 1, 1), stride=s)


@pytest.mark.parametrize("k,f_in,f_out,s,o", [(7, 2, 2, 1, 1), (3, 2, 1, 2, 1), (7, 2, 4, 1, 1), (3, 4, 4, 1, 0)])
def test_transform_kernel_packed_matches_jax(k, f_in, f_out, s, o):
    """An exact copy of JAX's transform; with f_in = f_out, stride 1 and no
    offset it is ``transform_kernel``, as in JAX."""
    w = np.random.default_rng(3).standard_normal((k, k, k, 2, 3)).astype(np.float32)
    want = jax_packed.transform_kernel_packed(jnp.asarray(w), f_in, f_out, s, (o,) * 3)
    _close(packed.transform_kernel_packed(_t(w), f_in, f_out, s, (o,) * 3), want, 0)
    A, K = jax_packed._axis_map_packed(k, f_in, f_out, s, o)
    got = packed._axis_map_packed_tensor(k, f_in, f_out, s, o, torch.float32, "cpu")
    assert got.shape[0] == K and torch.equal(got, torch.from_numpy(A))
    if f_in == f_out and s == 1 and o == 0:
        assert torch.equal(port_s2d.transform_kernel(_t(w), f_in), packed.transform_kernel_packed(_t(w), f_in, f_in))


def test_repack_and_affine_match_jax():
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 8, 8, 8, 3)).astype(np.float32)
    f2, f4 = port_s2d.space_to_depth(_t(x), 2), port_s2d.space_to_depth(_t(x), 4)
    assert torch.equal(packed.repack(f2, 2, 2, 3), f4)
    assert torch.equal(packed.unpack_repack(f4, 2, 2, 3), f2)
    _close(packed.repack(f2, 2, 2, 3), jax_packed.repack(jax_s2d.space_to_depth(jnp.asarray(x), 2), 2, 2, 3), 0)
    mult, add = rng.standard_normal(3).astype(np.float32), rng.standard_normal(3).astype(np.float32)
    want = jax_packed.packed_affine(jax_s2d.space_to_depth(jnp.asarray(x), 2), 2, jnp.asarray(mult), jnp.asarray(add))
    _close(packed.packed_affine(f2, 2, _t(mult), _t(add)), want)


def test_reflect_pad_packed_too_few_blocks():
    """The slabs need L+1 blocks per axis, as in JAX."""
    with pytest.raises(ValueError, match="blocks"):
        packed.reflect_pad_packed(torch.zeros(1, 1, 4, 4, 8), 2, 3)
    with pytest.raises(ValueError, match="blocks"):
        jax_packed.reflect_pad_packed(jnp.zeros((1, 1, 4, 4, 8)), 2, 3)


def test_packed_ops_backward_is_slices_and_convs():
    """The packed reflect pad's and the packed conv's backward run no
    scatter-add: two identical gradient calls are bit-equal (C3)."""
    rng = np.random.default_rng(5)
    x = _t(rng.standard_normal((2, 8, 8, 8, 16))).requires_grad_()
    w = _t(rng.standard_normal((7, 7, 7, 2, 3))).requires_grad_()

    def grads():
        xp, o = packed.reflect_pad_packed(x, 2, 3)
        out = packed.packed_conv3d(xp, w, f_in=2, f_out=2, o=(o,) * 3, out_blocks=(8, 8, 8))
        return torch.autograd.grad((out * out).sum(), (x, w))

    for a, b in zip(grads(), grads()):
        assert torch.equal(a, b)
