"""Model introspection helpers (counterpart of
``contrast_gan_3d_tpu/models/utils.py``)."""

from typing import List, Sequence

import numpy as np
from torch import nn


def generator_output_shape(input_spatial: Sequence[int], n_updownsample_blocks: int = 2) -> List[int]:
    """The generator is shape-preserving when every spatial dim is divisible by
    2**n_updownsample_blocks; otherwise downsampling ceil-divides and the
    transpose convs multiply back up, so output = ceil(d / 2^n) * 2^n."""
    factor = 2**n_updownsample_blocks
    return [int(np.ceil(d / factor)) * factor for d in input_spatial]


def count_parameters(module: nn.Module) -> int:
    """Total trainable parameter count of a module."""
    return sum(p.numel() for p in module.parameters())
