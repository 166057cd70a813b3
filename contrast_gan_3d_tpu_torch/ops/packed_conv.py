"""The packed layout's f32 block convolutions on the tensor cores.

``conv3d_cl_op`` is the ``torch.library`` operator
``contrast_gan_3d_torch::conv3d_cl``: the VALID 3D conv of a channels-last
``(B, X, Y, Z, Ci)`` tensor with a ``(Kx, Ky, Kz, Ci, Co)`` kernel at block
stride ``stride``, f32 in and out. Its CUDA implementation is one counted
launch of the hand-written Hopper kernel ``csrc/packed_conv.cu`` (3xTF32
on wgmma: f32 accuracy on the tensor cores); its CPU implementation is the
plain version ``conv3d_cl_reference`` (``F.conv3d`` on permuted views);
a fake implementation gives shapes, so ``torch.export`` of a packed
corrector keeps the operator whole.

``ops/s2d_conv.conv3d_cl``, the one call site of every packed stage conv,
takes the operator wherever x is f32 and no gradient is wanted
(``tc_common.needs_grad``); bf16 and every call that needs a gradient
(training) keep ``F.conv3d``. The wrapper counts its CUDA launches in
``conv3d_cl_tc.launches``; ``ops/block_conv.launch_counts`` reports them
beside B1's and B3's.

The kernel takes the weights K-major, ``(Co, Kx*Ky*Kz*Ci)`` (``kmajor``),
split into TF32 big and small parts once per call, and Ci a multiple of 4
(16 bytes), zero-padded here where it is not. Its flop formula counts the
work it executes, ``2 B Xo Yo Zo Kx Ky Kz Ci Co`` (``conv3d_cl_flops``),
what ``torch.utils.flop_counter`` counts for the ``F.conv3d`` it replaces.
"""

import ctypes
import math
from functools import lru_cache

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import flop_registry, register_flop_formula

from contrast_gan_3d_tpu_torch.ops import _build
from contrast_gan_3d_tpu_torch.ops.tc_common import OP_NAMESPACE, log_flops, tf32_split


def conv3d_cl_reference(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """The plain version: ``F.conv3d`` on the permuted views (the input is
    then in ``channels_last_3d`` memory format), a channels-last view of
    its output, in x's dtype."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), stride=stride)
    return y.permute(0, 2, 3, 4, 1)


def out_dims(x_shape, w_shape, stride: int) -> tuple:
    """The output's spatial dims: ``(d - k) // stride + 1`` per axis."""
    return tuple((d - k) // stride + 1 for d, k in zip(x_shape[1:4], w_shape[:3]))


def conv3d_cl_flops(x_shape, w_shape, stride: int) -> int:
    """FLOPs of one launch: 2 B Xo Yo Zo Kx Ky Kz Ci Co."""
    return 2 * x_shape[0] * math.prod(out_dims(x_shape, w_shape, stride)) * math.prod(w_shape)


def kmajor(w: torch.Tensor) -> torch.Tensor:
    """(Kx, Ky, Kz, Ci, Co) -> the (Co, Kx*Ky*Kz*Ci) K-major weight the
    kernel reads, K in w's (qx, qy, qz, ci) order."""
    return w.reshape(-1, w.shape[-1]).t().contiguous()


@lru_cache(maxsize=None)
def _kernel_fn():
    fn = _build.load("packed_conv").packed_conv3d_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def conv3d_cl_tc(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """One counted kernel launch on f32 CUDA tensors."""
    if x.dim() != 5 or w.dim() != 5 or w.shape[3] != x.shape[-1] or x.device != w.device:
        raise ValueError(f"conv3d_cl: x {tuple(x.shape)} on {x.device}, w {tuple(w.shape)} on {w.device}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"conv3d_cl's kernel takes f32 x and w; got {x.dtype}, {w.dtype}")
    pad = -x.shape[-1] % 4
    if pad:
        x, w = F.pad(x, (0, pad)), F.pad(w, (0, 0, 0, pad))
    x = x.contiguous()
    if x.data_ptr() % 16:  # a view at an odd offset; the copies are 16-byte
        x = x.clone()
    w_big, w_small = tf32_split(kmajor(w))
    b, X, Y, Z, ci = x.shape
    kx, ky, kz, _, co = w.shape
    out = torch.empty((b, *out_dims(x.shape, w.shape, stride), co), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _kernel_fn()(x.data_ptr(), w_big.data_ptr(), w_small.data_ptr(), out.data_ptr(),
                          b, X, Y, Z, ci, kx, ky, kz, stride, co, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv3d_cl kernel launch failed: CUDA error {rc}")
    conv3d_cl_tc.launches += 1
    return out


conv3d_cl_tc.launches = 0


def _cpu(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """The CPU implementation: the plain version, made contiguous
    channels-last as the fake implementation states."""
    return conv3d_cl_reference(x, w, stride).contiguous()


def _fake(x, w, stride):
    return x.new_empty((x.shape[0], *out_dims(x.shape, w.shape, stride), w.shape[-1]))


# Defined through ``torch.library.Library``, not ``custom_op``: a
# ``custom_op``'s first call imports ``torch._dynamo`` (its kernels are
# wrapped to disable it), seconds of a correction's set-up.
_LIB = torch.library.Library(OP_NAMESPACE, "FRAGMENT")
_LIB.define("conv3d_cl(Tensor x, Tensor w, int stride) -> Tensor")
_LIB.impl("conv3d_cl", _cpu, "CPU")
_LIB.impl("conv3d_cl", conv3d_cl_tc, "CUDA")
torch.library.register_fake(f"{OP_NAMESPACE}::conv3d_cl", _fake, lib=_LIB)
# the f32 conv without a gradient, as an operator ``torch.export`` keeps
# whole: the plain version for a CPU tensor, one counted kernel launch for
# a CUDA tensor; no other device
conv3d_cl_op = torch.ops.contrast_gan_3d_torch.conv3d_cl.default


def _flop(x_shape, w_shape, stride, *args, out_shape=None, **kwargs) -> int:
    n = conv3d_cl_flops(x_shape, w_shape, stride)
    log_flops("conv3d_cl", n)
    return n


if torch.ops.contrast_gan_3d_torch.conv3d_cl not in flop_registry:  # registered once per process
    register_flop_formula(torch.ops.contrast_gan_3d_torch.conv3d_cl)(_flop)
