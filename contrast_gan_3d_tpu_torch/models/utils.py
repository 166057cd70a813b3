"""Model introspection helpers (counterpart of
``contrast_gan_3d_tpu/models/utils.py``): torch-style conv output shapes,
the generator's architecture read back from its weights, and parameter
counts."""

import re
from typing import List, Mapping, Optional, Sequence

import numpy as np
from torch import nn


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
