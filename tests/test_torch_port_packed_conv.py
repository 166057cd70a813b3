"""The packed layout's f32 block-conv kernel (``ops/csrc/packed_conv.cu``,
``ops/packed_conv.py``) on the CPU: the kernel's K walk over (z-tap,
channel) runs with its K-major 3xTF32 weights, emulated at each of the
packed generator's six stage geometries; the dispatch rule of
``ops/s2d_conv.conv3d_cl``; the operator's flop formula; and a packed
corrector exported with the operator inside.

The CUDA kernel itself runs only on the card
(``tests/test_torch_port_packed_conv_card.py``); these tests hold the
arithmetic and the layouts it is handed.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from contrast_gan_3d_tpu_torch.eval.corrector import CCTAContrastCorrector
from contrast_gan_3d_tpu_torch.eval.export import export_corrector
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.ops import block_conv, packed_conv, s2d_conv, tc_common
from contrast_gan_3d_tpu_torch.ops.tc_common import tf32_split
from contrast_gan_3d_tpu_torch.ops.packed_conv import conv3d_cl_flops, conv3d_cl_op, conv3d_cl_tc, kmajor

OP = "contrast_gan_3d_torch.conv3d_cl.default"
STEP = 32  # floats per K step: one 128-byte row

# the packed generator's six stage convs (x's spatial dims cut small), as
# ``forward_packed`` hands them to ``conv3d_cl``: x (B, X, Y, Z, Ci), kernel
# (Kx, Ky, Kz, Ci, Co), block stride
STAGES = {
    "first": ((2, 12, 12, 12, 8), (5, 5, 5, 8, 128), 1),
    "down_0": ((1, 10, 10, 10, 128), (3, 3, 3, 128, 256), 2),
    "down_1": ((1, 6, 6, 6, 256), (2, 2, 2, 256, 64), 1),
    "up_0": ((2, 5, 5, 5, 64), (2, 2, 2, 64, 256), 1),
    "up_1": ((1, 9, 9, 9, 32), (2, 2, 2, 32, 128), 1),
    "last_conv": ((1, 10, 10, 10, 128), (6, 6, 6, 128, 64), 2),
}


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def k_walk(shape, kernel) -> np.ndarray:
    """The x offset (relative to an output voxel's base) that the kernel's
    loader copies into each K slot, -1 where it zero-fills: each of the 8
    chunks of 4 floats walks its own (qx, qy, r) along K by additions, one
    step (32 floats) at a time, as ``packed_conv3d_kernel``'s ``load`` does."""
    _, X, Y, Z, ci = shape
    kx, ky, kz = kernel[:3]
    K, R = kx * ky * kz * ci, kz * ci
    steps = -(-K // STEP)
    offs = np.full(steps * STEP, -1, np.int64)
    for chunk in range(STEP // 4):
        k = 4 * chunk
        p, r = divmod(k, R)
        qx, qy = divmod(p, ky)
        for step in range(steps):
            if k < K:
                offs[step * STEP + 4 * chunk: step * STEP + 4 * chunk + 4] = (qx * Y + qy) * Z * ci + r + np.arange(4)
            k += STEP
            r += STEP
            while r >= R:
                r -= R
                qy += 1
                if qy == ky:
                    qy, qx = 0, qx + 1
    return offs


def emulate(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """The kernel's arithmetic on the CPU: row bases decoded from m as the
    kernel decodes them, A gathered through :func:`k_walk` (zeros past K),
    the K-major weights zero-filled to whole steps, each operand split by
    ``tf32_split`` and the three products (small * big + big * small + big
    * big) exact and summed in f64."""
    b, X, Y, Z, ci = x.shape
    co = w.shape[-1]
    dims = packed_conv.out_dims(x.shape, w.shape, stride)
    m = torch.arange(b * math.prod(dims))
    oz, t = m % dims[2], m // dims[2]
    oy, t = t % dims[1], t // dims[1]
    ox, bb = t % dims[0], t // dims[0]
    base = (((bb * X + stride * ox) * Y + stride * oy) * Z + stride * oz) * ci
    offs = torch.from_numpy(k_walk(x.shape, w.shape))
    a = x.reshape(-1)[(base[:, None] + offs.clamp(min=0)[None, :])] * (offs >= 0)
    w_km = F.pad(kmajor(w), (0, offs.numel() - kmajor(w).shape[1]))
    (ab, as_), (wb, ws) = tf32_split(a), tf32_split(w_km)
    ab, as_, wb, ws = (v.double() for v in (ab, as_, wb, ws))
    out = as_ @ wb.t() + ab @ ws.t() + ab @ wb.t()
    return out.reshape(b, *dims, co)


@pytest.mark.parametrize("stage", list(STAGES))
def test_kernel_k_walk_equals_the_f64_conv(rng, stage):
    """At each stage geometry, the emulated kernel (its row decode, its K
    walk over runs of Kz * Ci floats laid end to end, its 3xTF32 products
    with the K-major split weights) equals ``F.conv3d`` in f64 within 1e-5
    of max|f64|; every K slot below K is copied exactly once."""
    x_shape, w_shape, stride = STAGES[stage]
    x = _t(rng.normal(size=x_shape))
    w = _t(rng.normal(size=w_shape) / np.sqrt(math.prod(w_shape[:4])))
    K = math.prod(w_shape[:4])
    offs = k_walk(x_shape, w_shape)
    assert (offs[:K] >= 0).all() and (offs[K:] == -1).all()
    assert len(np.unique(offs[:K])) == K
    truth = packed_conv.conv3d_cl_reference(x.double(), w.double(), stride)
    got = emulate(x, w, stride)
    assert got.shape == truth.shape
    rel = (got - truth).abs().max().item() / truth.abs().max().item()
    assert rel <= 1e-5, rel


@pytest.mark.parametrize("case", ["bf16", "x_requires_grad", "w_requires_grad", "f32_no_grad",
                                  "grad_mode_on_no_requires", "inference_mode"])
def test_conv3d_cl_dispatch_rule(rng, monkeypatch, case):
    """``conv3d_cl`` takes the operator for f32 x and w where no gradient is
    wanted, and ``F.conv3d`` for bf16 and wherever autograd records; on the
    CPU the operator is ``F.conv3d`` bit for bit and launches nothing."""
    seen = []

    def spy(x, w, stride):
        seen.append(stride)
        return conv3d_cl_op(x, w, stride)

    monkeypatch.setattr(s2d_conv, "conv3d_cl_op", spy)
    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    x = _t(rng.normal(size=(2, 7, 6, 9, 8))).to(dtype)
    w = _t(rng.normal(size=(3, 2, 4, 8, 16))).to(dtype)
    x.requires_grad_(case == "x_requires_grad")
    w.requires_grad_(case == "w_requires_grad")
    before = block_conv.launch_counts()
    if case == "f32_no_grad":
        with torch.no_grad():
            got = s2d_conv.conv3d_cl(x, w, 2)
    elif case == "inference_mode":
        with torch.inference_mode():
            got = s2d_conv.conv3d_cl(x, w, 2)
    else:
        got = s2d_conv.conv3d_cl(x, w, 2)
    engaged = case in ("f32_no_grad", "grad_mode_on_no_requires", "inference_mode")
    assert seen == ([2] if engaged else [])
    assert torch.equal(got.detach(), packed_conv.conv3d_cl_reference(x.detach(), w.detach(), 2))
    assert got.shape == (2, 3, 3, 3, 16) and got.dtype == dtype
    assert block_conv.launch_counts() == before  # a CPU call launches nothing
    # the operator's CUDA implementation is the counted launch
    assert torch._C._dispatch_has_kernel_for_dispatch_key("contrast_gan_3d_torch::conv3d_cl", "CUDA")
    assert (conv3d_cl_tc, "launches") in before


def test_conv3d_cl_rejects_a_w_of_another_dtype(rng):
    """f32 x without a gradient takes the operator whatever w's dtype, and
    the operator rejects a bf16 w: no call quietly leaves the kernel's
    path (on the card the launch raises ``TypeError``, here ``F.conv3d``
    raises)."""
    x = _t(rng.normal(size=(1, 5, 5, 5, 4)))
    w = _t(rng.normal(size=(2, 2, 2, 4, 8))).to(torch.bfloat16)
    with torch.no_grad(), pytest.raises((RuntimeError, TypeError)):
        s2d_conv.conv3d_cl(x, w, 1)


def test_flop_formula_counts_the_executed_work(rng):
    """The operator's formula is 2 B Xo Yo Zo Kx Ky Kz Ci Co at each stage
    geometry, what ``FlopCounterMode`` counts for the ``F.conv3d`` it
    replaces; ``FLOP_LOG`` records the launch."""
    for x_shape, w_shape, stride in STAGES.values():
        x, w = torch.zeros(x_shape), torch.zeros(w_shape)
        want = 2 * x_shape[0] * math.prod(packed_conv.out_dims(x_shape, w_shape, stride)) * math.prod(w_shape)
        assert conv3d_cl_flops(x_shape, w_shape, stride) == want
        tc_common.FLOP_LOG = []
        try:
            with FlopCounterMode(display=False) as op_mode:
                conv3d_cl_op(x, w, stride)
            log = tc_common.FLOP_LOG
        finally:
            tc_common.FLOP_LOG = None
        with FlopCounterMode(display=False) as plain_mode:
            packed_conv.conv3d_cl_reference(x, w, stride)
        assert op_mode.get_total_flops() == plain_mode.get_total_flops() == want
        assert log == [("conv3d_cl", want, want)]
    torch.library.opcheck(conv3d_cl_op, (_t(rng.normal(size=(1, 6, 5, 7, 4))), _t(rng.normal(size=(2, 2, 3, 4, 8))), 2))


def test_packed_corrector_exports_with_the_operator_inside(rng):
    """``torch.export`` of a small packed corrector on the CPU records every
    stage conv as the operator (stem, two downsamples, two upsamples and
    the projection: 6 a forward) and leaves the ResNet block's two convs
    to ``aten.conv3d``; the program gives the live corrector's result
    bit for bit."""
    torch.manual_seed(3)
    gen = ResnetGenerator(n_resnet_blocks=1, n_updownsample_blocks=2, init_channels_out=4).eval()
    corr = CCTAContrastCorrector(gen, inference_patch_size=(16, 16, 16), overlap=0.25, batch_size=8, device="cpu")
    assert corr.packed
    shape = (16, 16, 16)  # one window: the operator, not the grid, is under test
    program = export_corrector(corr, shape)
    ops = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    forwards = ops.count(OP) // 6
    assert forwards >= 1 and ops.count(OP) == 6 * forwards
    assert ops.count("aten.conv3d.default") == 2 * forwards
    vol = rng.integers(-1024, 1500, shape).astype(np.int16)
    got = program.module()(torch.from_numpy(vol))
    torch.testing.assert_close(got, corr(vol), rtol=0, atol=0)
