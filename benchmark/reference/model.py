"""Plain PyTorch reference of the contrast-GAN networks, written from the
published architecture (xqz-u/contrast-gan-3D, ``model/generator.py`` and
``model/discriminator.py``) and independent of the code under test.

Every network is a function of a parameter dict whose names follow the
published module names (``first.conv.weight``, ``resnet_0.block1.norm.bias``,
...). Convolutions are ``F.conv3d`` / ``F.conv2d`` in the direct layout,
float32, with no kernels of the program, no packing and no caching.

- Generator: 7^n reflect-padded stem, stride-2 downsamples, residual
  blocks, stride-2 transpose-conv upsamples whose size-preserving window
  starts at offset 0 of the full transpose conv (flax's SAME placement for
  k=3, s=2), 7^n reflect-padded projection to one channel, tanh.
- Critic: k=4, s=2, p=1 blocks with LeakyReLU(0.2), the first unnormalised
  with a bias, then a k=4, s=1, p=1 conv to one logit channel.
- BatchNorm: train mode normalises with the biased batch variance; eval mode
  with the running statistics; eps 1e-5.

``prec`` names a precision below float32 (None: float32). It is how the
benchmark computes its control, the same reference one precision step
lower. The convolutions' operands are rounded to it before they multiply,
in the forward pass (input and weight) and in the backward pass (the
gradient of the convolution's output, which both of its gradients
multiply). ``"tf32"`` (a 10-bit mantissa, what TF32 tensor cores read)
stops there. ``"bf16"`` and ``"fp8"`` are compute dtypes, as the program's
``dtype`` is: every block output (convolution, norm, activation, residual
sum) is held in it, forward and backward; parameters, statistics and
losses stay float32. ``"fp8"`` is e4m3 forward and e5m2 backward, each
tensor scaled by its largest magnitude.
"""

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
LEAKY_SLOPE = 0.2
FP8_MAX = 448.0
# the published intensity scaler: HU range (-1024, 1500), shift
# (1500 - 1024) // 2, divided by the largest HU change, 600
HU_SHIFT, HU_FACTOR = 238.0, 600.0


def scale(hu: torch.Tensor) -> torch.Tensor:
    """HU (any dtype) -> the networks' float32 input units."""
    return (hu.float() - HU_SHIFT) / HU_FACTOR


def unscale(x: torch.Tensor) -> torch.Tensor:
    return x * HU_FACTOR + HU_SHIFT


# fp8 formats: the forward's operands in e4m3, the backward's gradients in
# e5m2, each tensor scaled by its own largest magnitude (the usual fp8
# recipe: without the scale the critic's clipped weights would underflow)
FP8 = {"fwd": (torch.float8_e4m3fn, 448.0), "bwd": (torch.float8_e5m2, 57344.0)}


def _rounded(x: torch.Tensor, prec: str, pass_: str) -> torch.Tensor:
    if prec == "tf32":
        bits = x.float().contiguous().view(torch.int32)
        bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
        return bits.view(torch.float32).to(x.dtype)
    if prec == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    if prec == "fp8":
        dtype, top = FP8[pass_]
        amax = x.abs().max()
        scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
        return ((x * scale).clamp(-top, top).to(dtype).to(x.dtype) / scale)
    raise ValueError(f"unknown precision {prec!r}")


class _Round(torch.autograd.Function):
    """Round in the forward pass (``fwd``) or the gradient in the backward
    pass (``bwd``); the other pass is the identity."""

    @staticmethod
    def forward(ctx, x, prec, pass_):
        ctx.prec, ctx.pass_ = prec, pass_
        return _rounded(x, prec, "fwd") if pass_ == "fwd" else x.clone()

    @staticmethod
    def backward(ctx, g):
        return (_rounded(g, ctx.prec, "bwd") if ctx.pass_ == "bwd" else g), None, None


def round_to(x: torch.Tensor, prec: Optional[str]) -> torch.Tensor:
    """``x`` rounded to ``prec`` and back to its dtype (nearest, ties to
    even); the gradient passes through unchanged."""
    return x if prec is None else _Round.apply(x, prec, "fwd")


def round_grad(y: torch.Tensor, prec: Optional[str]) -> torch.Tensor:
    """``y`` unchanged; its gradient rounded to ``prec`` on the way back."""
    return y if prec is None else _Round.apply(y, prec, "bwd")


def stored(y: torch.Tensor, prec: Optional[str]) -> torch.Tensor:
    """A block's output held in a compute dtype ``prec`` ("bf16", "fp8"),
    rounded on the way forward and its gradient on the way back; TF32 and
    float32 hold float32."""
    return round_grad(round_to(y, prec), prec) if prec in ("bf16", "fp8") else y


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def generator_spec(n_resnet_blocks: int, n_updownsample_blocks: int, init_channels_out: int,
                   ndim: int) -> List[Tuple[str, tuple, int]]:
    """(name, shape, fan_in) of every generator parameter; fan_in 0 marks a
    norm scale (ones) or a bias (zeros)."""
    k3, k7, c0 = (3,) * ndim, (7,) * ndim, init_channels_out
    out = []

    def conv(name, c_out, c_in, k, transpose=False, bias=False, norm=True):
        shape = (c_in, c_out, *k) if transpose else (c_out, c_in, *k)
        out.append((f"{name}.conv.weight", shape, c_in * math.prod(k)))
        if bias:
            out.append((f"{name}.conv.bias", (c_out,), 0))
        if norm:
            out.extend([(f"{name}.norm.weight", (c_out,), 0), (f"{name}.norm.bias", (c_out,), 0)])

    conv("first", c0, 1, k7)
    for i in range(n_updownsample_blocks):
        conv(f"down_{i}", c0 * 2 ** (i + 1), c0 * 2**i, k3)
    c = c0 * 2**n_updownsample_blocks
    for i in range(n_resnet_blocks):
        conv(f"resnet_{i}.block0", c, c, k3)
        conv(f"resnet_{i}.block1", c, c, k3)
    for i in range(n_updownsample_blocks, 0, -1):
        conv(f"up_{i - 1}", c0 * 2 ** (i - 1), c0 * 2**i, k3, transpose=True)
    conv("last_conv", 1, c0, k7, bias=True, norm=False)
    return out


def critic_spec(init_channels_out: int, discriminator_depth: int, ndim: int,
                norm: Optional[str] = "batch") -> List[Tuple[str, tuple, int]]:
    """(name, shape, fan_in) of every critic parameter, as ``generator_spec``."""
    k4, c0 = (4,) * ndim, init_channels_out
    out = [("first.conv.weight", (c0, 1, *k4), math.prod(k4)), ("first.conv.bias", (c0,), 0)]
    c_in = c0
    for n in range(discriminator_depth):
        c_out = min(2 ** (n + 1), 8) * c0
        out.append((f"middle_{n}.conv.weight", (c_out, c_in, *k4), c_in * math.prod(k4)))
        if norm == "batch":
            out.extend([(f"middle_{n}.norm.weight", (c_out,), 0), (f"middle_{n}.norm.bias", (c_out,), 0)])
        else:
            out.append((f"middle_{n}.conv.bias", (c_out,), 0))
        c_in = c_out
    out.extend([("last.conv.weight", (1, c_in, *k4), c_in * math.prod(k4)), ("last.conv.bias", (1,), 0)])
    return out


def make_params(spec, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Seeded float32 weights on ``device``, drawn in one call: every kernel
    normal with std 1/sqrt(fan_in) (lecun normal), norm scales ones, biases
    zeros."""
    total = sum(math.prod(shape) for _, shape, fan_in in spec if fan_in)
    draws = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    params, at = {}, 0
    for name, shape, fan_in in spec:
        if fan_in:
            n = math.prod(shape)
            params[name] = (draws[at: at + n] / math.sqrt(fan_in)).reshape(shape)
            at += n
        elif name.endswith("norm.weight"):
            params[name] = torch.ones(shape, device=device)
        else:
            params[name] = torch.zeros(shape, device=device)
    return params


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _conv(x, w, b=None, stride=1, padding=0, prec=None):
    fn = F.conv3d if x.dim() == 5 else F.conv2d
    return round_grad(fn(round_to(x, prec), round_to(w, prec), b, stride=stride, padding=padding), prec)


def _tconv_same(x, w, prec=None):
    """Stride-2 k=3 transpose conv, size-preserving window at offset 0."""
    fn = F.conv_transpose3d if x.dim() == 5 else F.conv_transpose2d
    y = round_grad(fn(round_to(x, prec), round_to(w, prec), stride=2), prec)
    return y[(slice(None), slice(None)) + tuple(slice(0, 2 * n) for n in x.shape[2:])]


def _reflect(x, p):
    return F.pad(x, (p,) * (2 * (x.dim() - 2)), mode="reflect")


def batch_norm(x, P, name, train, stats=None, running=None):
    """BatchNorm over every dim but the channels'. Train mode records the
    batch mean and unbiased variance into ``stats`` (for running
    statistics); eval mode reads ``running``."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if train:
        axes = (0,) + tuple(range(2, x.dim()))
        mean = x.mean(axes)
        var = x.var(axes, unbiased=False)
        if stats is not None:
            n = x.numel() // x.shape[1]
            stats[f"{name}.norm.running_mean"] = mean.detach()
            stats[f"{name}.norm.running_var"] = (var * (n / (n - 1))).detach()
    else:
        mean, var = running[f"{name}.norm.running_mean"], running[f"{name}.norm.running_var"]
    return (x - mean.view(shape)) / torch.sqrt(var.view(shape) + BN_EPS) * P[f"{name}.norm.weight"].view(shape) \
        + P[f"{name}.norm.bias"].view(shape)


def generator(P, x, n_resnet_blocks, n_updownsample_blocks, *, train, stats=None, running=None, prec=None):
    """The attenuation map in (-1, 1) of scaled ``x`` (B, 1, *spatial)."""
    def bn(y, name):
        return stored(batch_norm(stored(y, prec), P, name, train, stats, running), prec)

    def relu(y):
        return stored(F.relu(y), prec)

    x = relu(bn(_conv(_reflect(x, 3), P["first.conv.weight"], prec=prec), "first"))
    for i in range(n_updownsample_blocks):
        x = relu(bn(_conv(x, P[f"down_{i}.conv.weight"], stride=2, padding=1, prec=prec), f"down_{i}"))
    for i in range(n_resnet_blocks):
        name = f"resnet_{i}"
        y = bn(_conv(x, P[f"{name}.block0.conv.weight"], padding=1, prec=prec), f"{name}.block0")
        y = relu(bn(_conv(y, P[f"{name}.block1.conv.weight"], padding=1, prec=prec), f"{name}.block1"))
        x = stored(x + y, prec)
    for i in range(n_updownsample_blocks, 0, -1):
        x = relu(bn(_tconv_same(x, P[f"up_{i - 1}.conv.weight"], prec=prec), f"up_{i - 1}"))
    x = stored(_conv(_reflect(x, 3), P["last_conv.conv.weight"], P["last_conv.conv.bias"], prec=prec), prec)
    return stored(torch.tanh(x), prec)


def critic(P, x, discriminator_depth, prec=None):
    """Patch-wise realism logits of ``x`` (B, 1, *spatial), train-mode
    BatchNorm (batch statistics)."""
    def leaky(y):
        return stored(F.leaky_relu(y, LEAKY_SLOPE), prec)

    x = leaky(stored(_conv(x, P["first.conv.weight"], P["first.conv.bias"], stride=2, padding=1, prec=prec), prec))
    for n in range(discriminator_depth):
        name = f"middle_{n}"
        x = stored(_conv(x, P[f"{name}.conv.weight"], P.get(f"{name}.conv.bias"), stride=2, padding=1, prec=prec),
                   prec)
        if f"{name}.norm.weight" in P:
            x = stored(batch_norm(x, P, name, train=True), prec)
        x = leaky(x)
    return stored(_conv(x, P["last.conv.weight"], P["last.conv.bias"], stride=1, padding=1, prec=prec), prec)
