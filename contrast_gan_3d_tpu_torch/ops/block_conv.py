"""The block-space 3^3 conv (counterpart of
``contrast_gan_3d_tpu/ops/pallas_conv.py``).

- ``block_conv3x3x3`` (B1): VALID 3^3 conv, x (B, Z, X, Y, Ci) z-major
  channels-last, w (3, 3, 3, Ci, Co) indexed [qx, qy, qz], f32 out
  (B, Z-2, X-2, Y-2, Co). A CUDA tensor runs the hand-written Hopper kernel
  ``csrc/block_conv.cu``; a CPU tensor runs the plain version
  ``block_conv3x3x3_reference``. There is no fallback between the two.
- ``s2d_conv3d_block`` (B3): stride-1 SAME conv through space-to-depth and
  B1, with B3's dispatch: plain ``s2d_conv3d`` for block kernels other than
  3^3 or dims that do not divide f; ``ValueError`` on an unknown
  ``padding_mode``.

Each wrapper counts, in its ``launches`` attribute, the times it launched
the CUDA kernel.
"""

import ctypes
from functools import lru_cache
from typing import Optional

import torch

from contrast_gan_3d_tpu_torch.ops import _build
from contrast_gan_3d_tpu_torch.ops.s2d_conv import (
    _axis_map,
    check_padding_mode,
    depth_to_space,
    pad_spatial,
    s2d_conv3d,
    space_to_depth,
    transform_kernel,
)

_C_SYMBOLS = {torch.float32: "block_conv3x3x3_f32", torch.bfloat16: "block_conv3x3x3_bf16"}


@lru_cache(maxsize=None)
def _kernel_fn(dtype: torch.dtype):
    fn = getattr(_build.load("block_conv"), _C_SYMBOLS[dtype])
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def block_conv3x3x3_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of B1: 27 shifted slices, each contracted with
    ``w[qx, qy, qz]`` in f32."""
    b, zi, xi, yi, ci = x.shape
    zo, xo, yo = zi - 2, xi - 2, yi - 2
    x, w = x.float(), w.float()
    out = torch.zeros((b, zo, xo, yo, w.shape[-1]), dtype=torch.float32, device=x.device)
    for qz in range(3):
        for qx in range(3):
            for qy in range(3):
                xa = x[:, qz : qz + zo, qx : qx + xo, qy : qy + yo, :]
                out += torch.einsum("bzxyc,cd->bzxyd", xa, w[qx, qy, qz])
    return out


def block_conv3x3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """B1: VALID 3^3 conv, x (B, Z, X, Y, Ci) -> f32 (B, Z-2, X-2, Y-2, Co)."""
    if x.dim() != 5 or w.dim() != 5 or tuple(w.shape[:3]) != (3, 3, 3):
        raise ValueError(f"expected x (B,Z,X,Y,Ci), w (3,3,3,Ci,Co); got {tuple(x.shape)}, {tuple(w.shape)}")
    b, zi, xi, yi, ci = x.shape
    co = w.shape[-1]
    if w.shape[3] != ci or min(zi, xi, yi) < 3:
        raise ValueError(f"incompatible x {tuple(x.shape)} and w {tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    if x.device.type == "cpu":
        return block_conv3x3x3_reference(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"no block_conv3x3x3 for device {x.device}")
    if x.dtype != w.dtype or x.dtype not in _C_SYMBOLS:
        raise TypeError(f"block_conv3x3x3 takes f32 or bf16 x and w of one dtype; got {x.dtype}, {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("block_conv3x3x3 needs contiguous x and w")
    out = torch.empty((b, zi - 2, xi - 2, yi - 2, co), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _kernel_fn(x.dtype)(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), b, zi, xi, yi, ci, co,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"block_conv3x3x3 kernel launch failed: CUDA error {rc}")
    block_conv3x3x3.launches += 1
    return out


block_conv3x3x3.launches = 0


def s2d_conv3d_block(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    f: int = 4,
    padding_mode: str = "zeros",
) -> torch.Tensor:
    """B3: drop-in for ``s2d_conv3d`` (stride 1, 3^3 block kernels — k in
    5..8 at f=4) backed by B1; x (B, X, Y, Z, Ci), w (k, k, k, Ci, Co)."""
    kx, ky, kz = w.shape[:3]
    Ks = [_axis_map(k, f)[1] for k in (kx, ky, kz)]
    B, X, Y, Z, ci = x.shape
    if Ks != [3, 3, 3] or any(d % f for d in (X, Y, Z)):
        return s2d_conv3d(x, w, bias, f=f, padding_mode=padding_mode)

    pads = [(k - 1) // 2 for k in (kx, ky, kz)]
    mode = check_padding_mode(padding_mode)
    xp = pad_spatial(x, [(p, p) for p in pads], mode)
    # right-pad bound as in the JAX wrapper: the padded length must divide f
    # AND give >= d/f + K - 1 blocks so the VALID block conv yields the full
    # output — even kernels (k=6: p=2) fall short of the second bound
    extra = [
        max((-(d + 2 * p)) % f, d + f * (K - 1) - (d + 2 * p))
        for d, p, K in zip((X, Y, Z), pads, Ks)
    ]
    if any(extra):
        xp = pad_spatial(xp, [(0, e) for e in extra])
    xs = space_to_depth(xp, f)  # (B, Xb+2, Yb+2, Zb+2, f^3 ci)
    ws = transform_kernel(w, f).to(x.dtype).contiguous()

    xs_t = xs.permute(0, 3, 1, 2, 4).contiguous()  # z-major for B1
    out = block_conv3x3x3(xs_t, ws)  # (B, Zb', Xb', Yb', f^3 co) f32
    if x.is_cuda:
        s2d_conv3d_block.launches += 1
    out = out.permute(0, 2, 3, 1, 4).to(x.dtype)
    out = out[:, : X // f, : Y // f, : Z // f]
    out = depth_to_space(out, f)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


s2d_conv3d_block.launches = 0
