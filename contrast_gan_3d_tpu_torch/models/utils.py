"""Model helpers (counterpart of ``contrast_gan_3d_tpu/models/utils.py``):
torch-style conv output shapes, the generator's architecture read back from
its weights, parameter counts, and flax's initial weights
(``init_like_flax``)."""

import math
import re
from typing import List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

# flax's truncated_normal correction: the std of a unit normal cut at +-2
TRUNCATED_NORMAL_STD = 0.87962566103423978
_CONVS = (nn.Conv2d, nn.Conv3d)
_TCONVS = (nn.ConvTranspose2d, nn.ConvTranspose3d)


def flax_fan_in(conv: nn.Module) -> int:
    """The fan-in flax's ``lecun_normal`` gives the kernel this module
    replaces: ``in_ch * prod(kernel)`` for a conv and for a transpose conv
    alike (flax's kernel is ``(*k, in, out)``). torch's
    ``_calculate_fan_in_and_fan_out`` reads a transpose conv's ``(in, out,
    *k)`` weight as ``out * prod(kernel)``, so it is not used."""
    return conv.in_channels * math.prod(conv.kernel_size)


@torch.no_grad()
def init_like_flax(module: nn.Module) -> nn.Module:
    """Draw ``module``'s initial weights as the JAX package's flax modules
    draw theirs: every conv and transpose-conv kernel from ``lecun_normal``
    (a normal cut at +-2 std, std ``sqrt(1 / fan_in) / 0.8796...``, the
    fan-in of :func:`flax_fan_in`), every conv bias zero; norm scales stay
    ones and norm biases zeros. Draws from torch's global generator (the
    builder seeds it). Returns ``module``."""
    for m in module.modules():
        if isinstance(m, _CONVS + _TCONVS):
            s = math.sqrt(1.0 / flax_fan_in(m)) / TRUNCATED_NORMAL_STD
            nn.init.trunc_normal_(m.weight, std=s, a=-2.0 * s, b=2.0 * s)
            if m.bias is not None:
                m.bias.zero_()
    return module


def conv_output_shape(
    dims: Sequence[int],
    kernel_size: int,
    padding: int,
    stride: int,
    dilation: int = 1,
    transpose_output_padding: Optional[int] = None,
) -> List[int]:
    """Spatial output dims of a (transpose) conv with torch's arithmetic."""
    if transpose_output_padding is not None:
        def f(x):
            return (x - 1) * stride - 2 * padding + dilation * (kernel_size - 1) + transpose_output_padding + 1
    else:
        def f(x):
            return int((x + 2 * padding - dilation * (kernel_size - 1) - 1) / stride + 1)
    return [f(d) for d in dims]


def generator_output_shape(input_spatial: Sequence[int], n_updownsample_blocks: int = 2) -> List[int]:
    """The generator is shape-preserving when every spatial dim is divisible by
    2**n_updownsample_blocks; otherwise downsampling ceil-divides and the
    transpose convs multiply back up, so output = ceil(d / 2^n) * 2^n."""
    factor = 2**n_updownsample_blocks
    return [int(np.ceil(d / factor)) * factor for d in input_spatial]


def derive_generator_arch(state_dict: Mapping) -> dict:
    """A ``ResnetGenerator``'s architecture from its ``state_dict``: the
    block counts from the ``down_<i>`` / ``resnet_<i>`` keys, the stem width
    and ``ndim`` from the first conv's weight ``(O, I, *kernel)``. The same
    dict as the JAX package's ``derive_generator_arch`` on the flax tree.
    What the weights cannot encode (``tconv_placement``, ``norm``) comes from
    the checkpoint's meta sidecar."""
    if "first.conv.weight" not in state_dict:
        raise ValueError("state_dict is not a ResnetGenerator's (no first.conv.weight)")
    weight = state_dict["first.conv.weight"]

    def blocks(prefix):
        return len({m.group(1) for k in state_dict if (m := re.match(rf"{prefix}_(\d+)\.", k))})

    return {
        "n_updownsample_blocks": blocks("down"),
        "n_resnet_blocks": blocks("resnet"),
        "init_channels_out": int(weight.shape[0]),
        "ndim": weight.dim() - 2,
    }


def count_parameters(module: nn.Module) -> int:
    """Total trainable parameter count of a module."""
    return sum(p.numel() for p in module.parameters())


def parameter_overview(module: nn.Module, prefix: str = "") -> str:
    """One line per parameter: name, shape, count."""
    return "\n".join(f"{prefix}{name:<60} {str(tuple(p.shape)):<20} {p.numel()}"
                     for name, p in module.named_parameters())
