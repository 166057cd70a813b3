"""Space-to-depth 3D convolution (counterpart of
``contrast_gan_3d_tpu/ops/s2d_conv.py``).

A stride-1 SAME conv with tiny channel counts (the generator's 7^3 stem,
1->16, and projection, 16->1, at full resolution) is computed by folding
f^3 spatial blocks into channels, convolving with a transformed kernel whose
contraction/output dims are f^3 larger, and unfolding again. For f=4 and
k=7 the block kernel is 3^3: the stem becomes a 64->1024 block conv and the
projection a 1024->64 one — the contraction ``ops/block_conv.py`` runs.

Per axis (stride s, SAME pad p = (k-1)//2), with output x = f*X + r and
padded source index s*x + T = f*(s*X + q) + d:
  W'[q, (d, ci), (r, co)] = W[f*q + d - s*r, ci, co]   (zero outside [0, k))
and the block kernel size is K = (s*(f-1) + k-1)//f + 1.

Public functions keep the JAX package's channels-last layout
``(B, X, Y, Z, C)``; kernels are ``(kx, ky, kz, Ci, Co)``. Channel orders:
input ``(dx, dy, dz, ci)`` d-major, output ``(rx, ry, rz, co)`` r-major.
"""

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from contrast_gan_3d_tpu_torch.ops.packed_conv import conv3d_cl_op, conv3d_cl_reference
from contrast_gan_3d_tpu_torch.ops.tc_common import needs_grad


@lru_cache(maxsize=64)
def _axis_map(k: int, f: int, s: int = 1) -> Tuple[np.ndarray, int]:
    """(K, f, f, k) 0/1 tensor A[q, d, r, T] = [f*q + d - s*r == T]."""
    K = (s * (f - 1) + k - 1) // f + 1
    A = np.zeros((K, f, f, k), np.float32)
    for q in range(K):
        for d in range(f):
            for r in range(f):
                T = f * q + d - s * r
                if 0 <= T < k:
                    A[q, d, r, T] = 1.0
    A.setflags(write=False)
    return A, K


def _axis_map_tensor(k: int, f: int, s: int, dtype, device) -> torch.Tensor:
    """:func:`_axis_map` built on ``device`` from aranges, so that no copy
    from host memory runs inside a step a CUDA graph captures (the
    equal-block, zero-offset case of ``ops/packed._axis_map_packed_tensor``)."""
    from contrast_gan_3d_tpu_torch.ops.packed import _axis_map_packed_tensor

    return _axis_map_packed_tensor(k, f, f, s, 0, dtype, device)


def transform_kernel(w: torch.Tensor, f: int, s: int = 1) -> torch.Tensor:
    """(kx,ky,kz,Ci,Co) -> (Kx,Ky,Kz, f^3*Ci, f^3*Co) space-to-depth kernel:
    the equal-block, zero-offset case of ``ops/packed.transform_kernel_packed``,
    as in the JAX package (local import: ``packed`` imports this module)."""
    from contrast_gan_3d_tpu_torch.ops.packed import transform_kernel_packed

    return transform_kernel_packed(w, f, f, s, (0, 0, 0))


def space_to_depth(x: torch.Tensor, f: int) -> torch.Tensor:
    """(B, X, Y, Z, C) -> (B, X/f, Y/f, Z/f, f^3*C), channel layout
    (dx, dy, dz, c) d-major."""
    b, X, Y, Z, c = x.shape
    x = x.reshape(b, X // f, f, Y // f, f, Z // f, f, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, X // f, Y // f, Z // f, f * f * f * c)


def depth_to_space(x: torch.Tensor, f: int) -> torch.Tensor:
    """Inverse of :func:`space_to_depth` for layout (r, co) r-major."""
    b, X, Y, Z, fc = x.shape
    c = fc // (f * f * f)
    x = x.reshape(b, X, Y, Z, f, f, f, c)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, X * f, Y * f, Z * f, c)


def _tconv_axis_map(k: int = 3, s: int = 2) -> np.ndarray:
    """(K, s, k) 0/1 array A[j, r, T] = [s*j - r == T] for flax's
    ``ConvTranspose(kernel=k, stride=s, padding='SAME')`` convention
    o[s*Y + r] = sum_j K[s*j - r] x[Y - 1 + j].

    Derived and verified for the k=3 s=2 window only (the generator's up
    path, the one transpose-conv shape of the model). Other kernels need a
    different output-window placement; refuse rather than return wrong
    values."""
    return _tconv_axis_map_tensor(k, s, torch.float32, "cpu").numpy()


def _tconv_axis_map_tensor(k: int, s: int, dtype, device) -> torch.Tensor:
    """:func:`_tconv_axis_map` built on ``device`` from aranges (no copy
    from host memory inside a captured step)."""
    if k != 3 or s != 2:
        raise NotImplementedError(
            f"d2s/packed transpose conv is derived for kernel 3 stride 2 only (got k={k}, s={s}); "
            "use a direct ConvTranspose for other shapes"
        )
    K = (k - 1) // s + 1
    idx = lambda n: torch.arange(n, device=device)
    j, r, T = idx(K)[:, None, None], idx(s)[:, None], idx(k)
    return (s * j - r == T).to(dtype)


def conv3d_cl(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """VALID 3D conv of a channels-last ``(B, X, Y, Z, Ci)`` tensor with a
    ``(kx, ky, kz, Ci, Co)`` kernel at ``stride``; x's dtype in and out,
    channels-last out. f32 x where no gradient is wanted: the operator
    ``ops/packed_conv.conv3d_cl_op`` (the 3xTF32 tensor-core kernel on the
    card, ``F.conv3d`` on the CPU; either rejects a w of another dtype).
    Otherwise (bf16, or autograd recording: training) ``F.conv3d`` on the
    permuted views (``conv3d_cl_reference``)."""
    if x.dtype == torch.float32 and not needs_grad(x, w):
        return conv3d_cl_op(x, w, stride)
    return conv3d_cl_reference(x, w, stride)


def zero_pad_cl(x: torch.Tensor, pads) -> torch.Tensor:
    """Zero-pad the spatial dims of a channels-last ``(B, X, Y, Z, C)``
    tensor by ``pads = ((lo, hi), (lo, hi), (lo, hi))`` in one constant
    ``F.pad`` (whose backward is a slice)."""
    flat = [0, 0] + [p for lo_hi in reversed(pads) for p in lo_hi]
    return F.pad(x, flat)


def d2s_tconv3d(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 2,
    convention: str = "torch",
) -> torch.Tensor:
    """Exact stride-s transpose conv as a stride-1 conv producing s^3-packed
    channels (``ops/packed.packed_tconv3d``), then depth-to-space. x (B, X,
    Y, Z, Ci) channels-last; w (k, k, k, Ci, Co) in flax's unflipped layout;
    out (B, sX, sY, sZ, Co) in x's dtype, the bias added after the
    depth-to-space in x's dtype, as the JAX version adds it.

    ``convention``: the window of the size-preserving output, one voxel
    apart: "torch" (torch ``ConvTranspose(k, s, p=(k-1)//2, op=s-1)`` =
    full[1 : sN+1], reference-checkpoint parity) or "same" (flax
    ``ConvTranspose(padding='SAME')`` = full[0 : sN])."""
    from contrast_gan_3d_tpu_torch.ops.packed import packed_tconv3d

    out = depth_to_space(packed_tconv3d(x, w, None, stride, convention), stride)
    return out if bias is None else out + bias.to(x.dtype)


def check_padding_mode(padding_mode: str) -> str:
    """The ``F.pad`` mode for a conv ``padding_mode``; a typo must not run
    silently with zero borders (the generator's stem and projection depend
    on reflect padding)."""
    if padding_mode not in ("reflect", "zeros"):
        raise ValueError(
            f"unknown padding_mode {padding_mode!r}: expected 'zeros' | 'reflect'"
        )
    return "reflect" if padding_mode == "reflect" else "constant"


def reflect_pad(x: torch.Tensor, pads, dims) -> torch.Tensor:
    """``F.pad(mode="reflect")`` of ``x`` along ``dims`` by ``pads = ((lo,
    hi), ...)``, one pair per dim, built from slices, flips and
    concatenations. The forward is the same copy as ``F.pad``'s; the
    backward is slices and adds, where ``F.pad``'s CUDA backward
    accumulates with atomics and does not repeat bit for bit."""
    for dim, (lo, hi) in zip(dims, pads):
        n = x.shape[dim]
        if max(lo, hi) >= n:
            raise ValueError(f"reflect pad ({lo}, {hi}) needs more than {n} elements along dim {dim}")
        parts = [x.narrow(dim, 1, lo).flip(dim)] if lo else []
        parts.append(x)
        if hi:
            parts.append(x.narrow(dim, n - 1 - hi, hi).flip(dim))
        x = torch.cat(parts, dim) if len(parts) > 1 else x
    return x


def pad_spatial(x: torch.Tensor, pads, mode: str = "constant") -> torch.Tensor:
    """Pad the three spatial dims of a channels-last ``(B, X, Y, Z, C)``
    tensor by ``pads = ((lo, hi), (lo, hi), (lo, hi))``: zeros through
    ``F.pad`` (on the trailing dims of a channels-first view), reflect
    through :func:`reflect_pad`."""
    if mode == "reflect":
        return reflect_pad(x, pads, dims=(1, 2, 3))
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]  # z first, as F.pad
    y = F.pad(x.permute(0, 4, 1, 2, 3), flat, mode=mode)
    return y.permute(0, 2, 3, 4, 1)


def s2d_conv3d(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    f: int = 4,
    stride: int = 1,
    padding_mode: str = "zeros",
) -> torch.Tensor:
    """SAME-style 3D convolution via space-to-depth — the plain version
    (the block conv is one ``F.conv3d``; ``ops/block_conv.s2d_conv3d_block``
    is the kernel route).

    x: (B, X, Y, Z, Ci) with X/s, Y/s, Z/s divisible by ``f``; w:
    (k,k,k,Ci,Co); pre-pad (k-1)//2 per side. ``padding_mode``: 'zeros' |
    'reflect'. The conv runs on x's dtype and its output and the bias add
    stay in it (bf16 in, bf16 out), as the JAX version's
    ``preferred_element_type=x.dtype``."""
    kx, ky, kz = w.shape[:3]
    b, X, Y, Z, ci = x.shape
    s = stride
    out_dims = (X // s, Y // s, Z // s)
    if any(d % f for d in out_dims):
        raise ValueError(f"output dims {out_dims} must divide f={f}")

    pads = [(kx - 1) // 2, (ky - 1) // 2, (kz - 1) // 2]
    mode = check_padding_mode(padding_mode)
    xp = pad_spatial(x, [(p, p) for p in pads], mode)
    # right-pad with zeros so (a) the length divides f and (b) the block
    # VALID conv yields >= out/f blocks: len >= d_in + f*(K - s). The extra
    # zeros are provably never read (max read = s*out - s + k - 1 < d+2p).
    Ks = [(s * (f - 1) + k - 1) // f + 1 for k in (kx, ky, kz)]
    req = [
        max(-(-(d + 2 * p) // f) * f, d + f * (K - s))
        for d, p, K in zip((X, Y, Z), pads, Ks)
    ]
    extra = [r - (d + 2 * p) for r, d, p in zip(req, (X, Y, Z), pads)]
    if any(e > 0 for e in extra):
        xp = pad_spatial(xp, [(0, max(0, e)) for e in extra])

    xs = space_to_depth(xp, f)
    ws = transform_kernel(w, f, s).to(x.dtype)
    out = F.conv3d(
        xs.permute(0, 4, 1, 2, 3), ws.permute(4, 3, 0, 1, 2), stride=s
    ).permute(0, 2, 3, 4, 1)
    # the VALID output may overhang the true block count — trim
    out = out[:, : out_dims[0] // f, : out_dims[1] // f, : out_dims[2] // f]
    out = depth_to_space(out, f)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out
