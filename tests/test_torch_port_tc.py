"""The tensor-core block conv's host-side pieces, on the CPU: the TF32
split behind the f32 kernel's 3xTF32 products (and the tolerance decision
it records), the K-major weights, the channel padding, the weight of B1's
input gradient, and B3's weight permutation in place of data transposes.

The CUDA kernel itself runs only on the card (``chip_smoke.py``); these
tests hold the arithmetic and the layouts it is handed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from contrast_gan_3d_tpu.ops.pallas_conv import block_conv3x3x3 as jax_block_conv
from contrast_gan_3d_tpu_torch.ops.block_conv import (
    TF32_DROP,
    _reference,
    block_conv3x3x3,
    block_conv3x3x3_reference,
    dx_weight,
    from_kmajor,
    kmajor,
    pad_channels,
    s2d_conv3d_block,
    tf32_round,
    tf32_split,
)
from contrast_gan_3d_tpu_torch.ops.s2d_conv import pad_spatial, space_to_depth, transform_kernel


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _conv_f64(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """B1's contraction in float64 on float64 operands (no rounding of its
    own beyond f64): the truth the split schemes are held against."""
    zo, xo, yo = (d - 2 for d in x.shape[1:4])
    out = 0
    for qx in range(3):
        for qy in range(3):
            for qz in range(3):
                xa = x[:, qz : qz + zo, qx : qx + xo, qy : qy + yo, :]
                out = out + torch.einsum("bzuvc,cd->bzuvd", xa, w[qx, qy, qz])
    return out


def test_tf32_split_drops_13_bits_and_keeps_the_rest(rng):
    v = _t(rng.normal(size=4096) * np.exp(rng.uniform(-20, 20, size=4096)))
    big, small = tf32_split(v)
    for part in (big, small):
        assert not (part.view(torch.int32) & TF32_DROP).any()
    # big rounds to within half a TF32 ulp, small the remainder likewise
    rest = (v.double() - big.double() - small.double()).abs()
    assert (rest <= 2.0**-22 * v.double().abs()).all()
    assert ((v.double() - big.double()).abs() <= 2.0**-11 * v.double().abs()).all()


def test_tf32_round_is_nearest_with_ties_away_from_zero():
    bits = torch.tensor([0x3F801000, 0x3F800FFF, 0x3F803000, -0x407FF000], dtype=torch.int32)
    got = tf32_round(bits.view(torch.float32)).view(torch.int32).tolist()
    # a tie rounds away from zero in magnitude, whatever the sign
    assert got == [0x3F802000, 0x3F800000, 0x3F804000, -0x407FE000]


def test_3xtf32_meets_the_f32_check_where_one_tf32_product_does_not(rng):
    """The tolerance decision of the f32 kernel, at the projection's K =
    27 * 1024: the kernel's three products (small * w_big + big * w_small
    + big * w_big, each operand split by ``tf32_split``, products exact in
    f32 and summed here in f64) land within 1e-5 of max|f64 truth|; one
    TF32 product (both operands rounded once) misses the port's 1e-4."""
    x = torch.from_numpy(rng.normal(size=(2, 3, 6, 6, 1024)))
    w = torch.from_numpy(rng.normal(size=(3, 3, 3, 1024, 32)) / np.sqrt(27 * 1024))
    x32, w32 = x.float(), w.float()
    truth = _conv_f64(x32.double(), w32.double())
    (xb, xs), (wb, ws) = tf32_split(x32), tf32_split(w32)
    xb, xs, wb, ws = (t.double() for t in (xb, xs, wb, ws))
    three = _conv_f64(xs, wb) + _conv_f64(xb, ws) + _conv_f64(xb, wb)
    one = _conv_f64(xb, wb)
    scale = truth.abs().max().item()
    err3 = (three - truth).abs().max().item() / scale
    err1 = (one - truth).abs().max().item() / scale
    assert err3 <= 1e-5, err3
    assert err1 > 1e-4, err1


def test_kmajor_orders_taps_as_the_kernel_decodes_them(rng):
    w = _t(rng.normal(size=(3, 3, 3, 4, 5)))
    km = kmajor(w)
    assert tuple(km.shape) == (27, 5, 4)
    for qx, qy, qz in [(0, 0, 0), (2, 1, 0), (1, 2, 2), (0, 2, 1)]:
        torch.testing.assert_close(km[qx * 9 + qy * 3 + qz], w[qx, qy, qz].t(), rtol=0, atol=0)
    torch.testing.assert_close(from_kmajor(km.contiguous()), w, rtol=0, atol=0)


@pytest.mark.parametrize("dtype,multiple", [(torch.float32, 4), (torch.bfloat16, 8)])
def test_channel_padding_keeps_the_plain_result(rng, dtype, multiple):
    """The ragged chip case, x (2, 5, 7, 9, 3) -> Co 5: zero channels up to
    16 bytes change nothing; a Ci already a multiple is left alone."""
    x = _t(rng.normal(size=(2, 5, 7, 9, 3))).to(dtype)
    w = _t(rng.normal(size=(3, 3, 3, 3, 5))).to(dtype)
    xp, wp = pad_channels(x, kmajor(w))
    assert xp.shape[-1] == wp.shape[-1] == multiple and wp.shape[1] == 5
    # the padded channels are exactly zero and the rest is x and w as given
    assert not xp[..., 3:].any() and not wp[..., 3:].any()
    assert torch.equal(xp[..., :3], x) and torch.equal(wp[..., :3], kmajor(w))
    # the two f32 einsums (over Ci = 3 and over the padded Ci) sum in another
    # order, so they agree to rounding, not bit for bit
    plain = block_conv3x3x3_reference(x, w)
    padded = _reference(xp, from_kmajor(wp.contiguous()), "zxy")
    np.testing.assert_allclose(padded.numpy(), plain.numpy(), rtol=0, atol=1e-6 * plain.abs().max().item())
    x8 = torch.zeros((1, 3, 3, 3, 8), dtype=dtype)
    assert pad_channels(x8, kmajor(torch.zeros((3, 3, 3, 8, 2), dtype=dtype)))[0] is x8


@pytest.mark.parametrize("layout", ["zxy", "zyx"])
def test_dx_weight_gives_autograd_input_gradient(rng, layout):
    """dx = the plain conv of dy padded by 2 with the K-major weight
    ``dx_weight(w)`` (the flipped weight, no Ci/Co transpose), against
    autograd through the plain version on non-cubic shapes. 1e-5 of
    max|dx|: f32 sums in another order."""
    x = _t(rng.normal(size=(2, 5, 6, 7, 3))).requires_grad_(True)
    w = _t(rng.normal(size=(3, 3, 3, 3, 4)))
    dy = _t(rng.normal(size=(2, 3, 4, 5, 4)))
    _reference(x, w, layout).backward(dy)
    km = dx_weight(w)
    assert tuple(km.shape) == (27, 3, 4)
    got = _reference(F.pad(dy, (0, 0, 2, 2, 2, 2, 2, 2)), from_kmajor(km), layout)
    np.testing.assert_allclose(got.numpy(), x.grad.numpy(), atol=1e-5 * x.grad.abs().max().item())


@pytest.mark.parametrize("x_shape,ci,co", [((1, 8, 12, 16, 2), 2, 3), ((2, 8, 8, 4, 1), 1, 4)])
def test_b3_weight_permutation_replaces_the_data_transposes(rng, x_shape, ci, co):
    """B1 on the (X, Y, Z) block grid with the weights permuted (1, 2, 0)
    equals B1 on the z-major transposed grid, transposed back; both equal
    the JAX Pallas B1 (interpret mode) on the z-major grid."""
    x = _t(rng.normal(size=x_shape))
    w = _t(rng.normal(size=(7, 7, 7, ci, co)))
    xs = space_to_depth(pad_spatial(x, [(3, 5)] * 3), 4)
    ws = transform_kernel(w, 4)
    got = block_conv3x3x3(xs, ws.permute(1, 2, 0, 3, 4).contiguous())
    xs_t = xs.permute(0, 3, 1, 2, 4).contiguous()
    want = block_conv3x3x3_reference(xs_t, ws).permute(0, 2, 3, 1, 4)
    scale = want.abs().max().item()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5 * scale)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jax_block_conv(jnp.asarray(xs_t.numpy()), jnp.asarray(ws.numpy())))
    np.testing.assert_allclose(got.numpy(), pallas.transpose(0, 2, 3, 1, 4), atol=1e-5 * scale)


def test_b3_hands_b1_the_space_to_depth_grid_itself(rng, monkeypatch):
    """``s2d_conv3d_block`` passes B1 the space-to-depth output object
    itself, not a transposed copy, and the weights ordered [ky, kz, kx]."""
    import contrast_gan_3d_tpu_torch.ops.block_conv as bc

    seen = {}

    def s2d_spy(x, f):
        seen["s2d"] = space_to_depth(x, f)
        return seen["s2d"]

    def b1_spy(x, w):
        seen["b1"] = (x, w)
        return block_conv3x3x3(x, w)

    monkeypatch.setattr(bc, "space_to_depth", s2d_spy)
    monkeypatch.setattr(bc, "block_conv3x3x3", b1_spy)
    x = _t(rng.normal(size=(1, 8, 8, 8, 1)))
    w = _t(rng.normal(size=(7, 7, 7, 1, 2)))
    s2d_conv3d_block(x, w, f=4, padding_mode="reflect")
    x_b1, w_b1 = seen["b1"]
    assert x_b1 is seen["s2d"]
    torch.testing.assert_close(w_b1, transform_kernel(w, 4).permute(1, 2, 0, 3, 4), rtol=0, atol=0)


def test_generator_gradients_through_the_custom_ops(rng, monkeypatch):
    """A generator forward and backward whose stem and projection run B3 and
    B1 as ``torch.library`` operators (``BlockConv3x3x3Function`` around
    ``block_conv_op``) gives the gradients of the same generator with those
    stages on the plain ``s2d_conv3d``, to 1e-5 of each gradient's max (f32
    sums in another order); under no_grad the operator path gives the
    gradient path's forward bit for bit, and both operators pass
    ``torch.library.opcheck``."""
    from contrast_gan_3d_tpu_torch.models import blocks
    from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
    from contrast_gan_3d_tpu_torch.ops.block_conv import block_conv_op, s2d_conv3d_block_op
    from contrast_gan_3d_tpu_torch.ops.s2d_conv import s2d_conv3d

    torch.manual_seed(5)
    gen = ResnetGenerator(n_resnet_blocks=1, n_updownsample_blocks=1, init_channels_out=4)
    x = _t(rng.normal(0, 0.5, (2, 1, 16, 16, 16)))
    dy = _t(rng.normal(size=(2, 1, 16, 16, 16)))

    def grads():
        gen.zero_grad()
        out = gen(x)
        out.backward(dy)
        return out.detach(), {k: p.grad.clone() for k, p in gen.named_parameters()}

    out, got = grads()
    with torch.no_grad():
        assert torch.equal(gen(x), out)
    monkeypatch.setattr(blocks, "s2d_conv3d_block", s2d_conv3d)
    out_plain, want = grads()
    np.testing.assert_allclose(out.numpy(), out_plain.numpy(), atol=1e-5 * out_plain.abs().max().item())
    for k, g in want.items():
        np.testing.assert_allclose(got[k].numpy(), g.numpy(), atol=1e-5 * g.abs().max().item(), err_msg=k)
    xb = _t(rng.normal(size=(1, 8, 8, 8, 2)))
    wb = _t(rng.normal(size=(7, 7, 7, 2, 3)))
    for padding_mode, bias in (("reflect", _t(rng.normal(size=(3,)))), ("zeros", None)):
        torch.library.opcheck(s2d_conv3d_block_op, (xb, wb, bias, 4, padding_mode))
    km = kmajor(wb[:3, :3, :3]).contiguous()
    torch.library.opcheck(block_conv_op, (_t(rng.normal(size=(1, 5, 6, 7, 2))), km, "zyx"))
