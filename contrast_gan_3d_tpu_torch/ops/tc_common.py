"""What the wrappers of the hand-written tensor-core kernels share
(``ops/block_conv.py``'s B1-B3, ``ops/packed_conv.py``'s packed stage
conv), as their CUDA sources share ``csrc/tc_common.cuh``: the operators'
namespace, the rule for when autograd records a call, the split of f32
operands into TF32 big and small parts for the 3xTF32 products, and the
log of the counted launches' FLOPs.

While ``FLOP_LOG`` is a list, each counted launch (and B1's
``weight_grad``) appends ``(name, executed, model)`` to it: model is the
7^3 conv's count where the launch serves a B3 stage, else the executed
count (``flops_accounting`` sets it and reads both totals).
"""

from typing import Optional

import torch

OP_NAMESPACE = "contrast_gan_3d_torch"
TF32_DROP = 0x1FFF  # the 13 low mantissa bits that TF32 does not keep
# (name, executed FLOPs, model FLOPs) of each counted launch while a list
FLOP_LOG: Optional[list] = None


def needs_grad(*tensors) -> bool:
    """Whether autograd records a call on ``tensors`` (None ignored)."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~TF32_DROP).view(torch.float32)


def tf32_split(v: torch.Tensor):
    """(big, small): ``big = tf32_round(v)``, ``small = tf32_round(v - big)``;
    ``|v - big - small| <= 2^-22 |v|``."""
    big = tf32_round(v)
    return big, tf32_round(v - big)


def log_flops(name: str, executed: int, model: Optional[int] = None) -> None:
    """Append a launch to ``FLOP_LOG`` while it is a list."""
    if FLOP_LOG is not None:
        FLOP_LOG.append((name, executed, executed if model is None else model))
