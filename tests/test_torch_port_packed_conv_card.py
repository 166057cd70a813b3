"""The packed layout's f32 block-conv kernel (``ops/csrc/packed_conv.cu``)
on the card: each of the six stage convs at its full shape against
``F.conv3d`` in f64, a packed generator forward against the same generator
with the kernel bypassed, the launches of one corrected 512x512x400
volume, and none in a training cycle. Skips without a CUDA card; this file
imports neither JAX nor the JAX package. On the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_packed_conv_card.py -q
"""

import math

import pytest
import torch

from contrast_gan_3d_tpu_torch.eval.corrector import CCTAContrastCorrector
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.ops import packed_conv, s2d_conv
from contrast_gan_3d_tpu_torch.ops.packed_conv import conv3d_cl_op, conv3d_cl_reference, conv3d_cl_tc
from contrast_gan_3d_tpu_torch.utils.device import full_f32

# x (B, X, Y, Z, Ci), kernel (Kx, Ky, Kz, Ci, Co), block stride: the packed
# basic_3d generator's stage convs on a 128^3 window, batch 2
STAGES = {
    "first": ((2, 68, 68, 68, 8), (5, 5, 5, 8, 128), 1),
    "down_0": ((2, 66, 66, 66, 128), (3, 3, 3, 128, 256), 2),
    "down_1": ((2, 34, 34, 34, 256), (2, 2, 2, 256, 64), 1),
    "up_0": ((2, 33, 33, 33, 64), (2, 2, 2, 64, 256), 1),
    "up_1": ((2, 65, 65, 65, 32), (2, 2, 2, 32, 128), 1),
    "last_conv": ((2, 68, 68, 68, 128), (6, 6, 6, 128, 64), 2),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda")


def _launches():
    return conv3d_cl_tc.launches


@pytest.mark.parametrize("stage", list(STAGES))
def test_kernel_equals_the_f64_conv_at_each_stage(card, stage):
    """max|kernel - f64| / max|f64| <= 1e-5 at the full stage shape (the
    3xTF32 products read about 1e-6)."""
    x_shape, w_shape, stride = STAGES[stage]
    g = torch.Generator(device=card).manual_seed(23)
    x = torch.randn(x_shape, generator=g, device=card)
    w = torch.randn(w_shape, generator=g, device=card) / math.sqrt(math.prod(w_shape[:4]))
    before = _launches()
    with torch.no_grad():
        got = s2d_conv.conv3d_cl(x, w, stride)
    torch.cuda.synchronize()
    assert _launches() == before + 1
    truth = conv3d_cl_reference(x.double(), w.double(), stride)
    assert got.shape == truth.shape and got.is_contiguous()
    rel = (got.double() - truth).abs().max().item() / truth.abs().max().item()
    print(f"{stage}: max|err| / max|f64| {rel:.3e}")
    assert rel <= 1e-5, rel


def test_packed_forward_equals_the_bypassed_generator(card, monkeypatch):
    """The basic_3d generator's packed forward at batch 2 of 128^3, eval,
    f32: six launches, within 1e-5 of max|out| of the same forward with
    every stage conv on ``F.conv3d`` in full f32."""
    torch.manual_seed(7)
    gen = ResnetGenerator(layout="packed").to(card).eval()
    x = torch.rand((2, 1, 128, 128, 128), device=card) * 2 - 1
    before = _launches()
    with torch.no_grad(), full_f32():
        got = gen(x)
        torch.cuda.synchronize()
        assert _launches() == before + 6
        monkeypatch.setattr(s2d_conv, "conv3d_cl_op", conv3d_cl_reference)
        want = gen(x)
    rel = (got - want).abs().max().item() / want.abs().max().item()
    print(f"packed forward: max|err| / max|out| {rel:.3e}")
    assert rel <= 1e-5, rel
    assert _launches() == before + 6


def test_one_volume_reads_78_launches(card):
    """A 512x512x400 volume through the packed corrector at its defaults
    (294 windows of 128^3 at overlap 0.5, 13 batches of 24): 6 stage
    launches a batch, 78 in all."""
    torch.manual_seed(11)
    gen = ResnetGenerator(layout="packed").to(card).eval()
    corr = CCTAContrastCorrector(gen, inference_patch_size=(128, 128, 128), overlap=0.5, device=card)
    assert corr.packed and corr.batch_size == 24
    vol = torch.randint(-1024, 1500, (512, 512, 400), dtype=torch.int16).numpy()
    before = _launches()
    out = corr(vol)
    torch.cuda.synchronize()
    assert out.shape == (512, 512, 400) and torch.isfinite(out).all()
    assert _launches() == before + 78


def test_training_cycles_launch_nothing(card):
    """The benchmark's ``train.basic_3d`` cell (bf16 training, replayed
    cycles) runs correct and launches the kernel 0 times: bf16 and
    gradients keep ``F.conv3d``."""
    from benchmark import run as runner

    before = _launches()
    result, _ = runner.run_cell("train.basic_3d", 2**31 + 77, 3.0, False)
    assert result["correct"] is True, result["checks"]
    assert _launches() == before


def test_operator_launch_matches_the_plain_operator_shapes(card):
    """A ragged case: Ci 3 (padded to 4 inside), Co 5, block stride 2,
    taps 2 x 3 x 4, through the operator; 1e-5 of the f64 conv."""
    g = torch.Generator(device=card).manual_seed(5)
    x = torch.randn((3, 9, 10, 11, 3), generator=g, device=card)
    w = torch.randn((2, 3, 4, 3, 5), generator=g, device=card)
    got = conv3d_cl_op(x, w, 2)
    truth = conv3d_cl_reference(x.double(), w.double(), 2)
    assert got.shape == truth.shape == (3, *packed_conv.out_dims(x.shape, w.shape, 2), 5)
    assert (got.double() - truth).abs().max().item() <= 1e-5 * truth.abs().max().item()


def test_a_w_of_another_dtype_is_rejected(card):
    """f32 x without a gradient takes the operator whatever w's dtype; the
    launch rejects a bf16 w before it launches anything."""
    x = torch.randn((1, 6, 6, 6, 8), device=card)
    w = torch.randn((2, 2, 2, 8, 64), device=card, dtype=torch.bfloat16)
    before = _launches()
    with torch.no_grad(), pytest.raises(TypeError):
        s2d_conv.conv3d_cl(x, w, 1)
    assert _launches() == before
