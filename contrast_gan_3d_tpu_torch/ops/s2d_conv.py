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
    from host memory runs inside a step a CUDA graph captures."""
    K = (s * (f - 1) + k - 1) // f + 1
    idx = lambda n: torch.arange(n, device=device)
    q, d, r, T = idx(K)[:, None, None, None], idx(f)[:, None, None], idx(f)[:, None], idx(k)
    return (f * q + d - s * r == T).to(dtype)


def transform_kernel(w: torch.Tensor, f: int, s: int = 1) -> torch.Tensor:
    """(kx,ky,kz,Ci,Co) -> (Kx,Ky,Kz, f^3*Ci, f^3*Co) space-to-depth kernel
    (the equal-block, zero-offset case of the JAX package's
    ``transform_kernel_packed``)."""
    kx, ky, kz, ci, co = w.shape
    maps = [_axis_map_tensor(k, f, s, w.dtype, w.device) for k in (kx, ky, kz)]
    # W'[qx,dx,rx, qy,dy,ry, qz,dz,rz, ci,co]
    wp = torch.einsum("adrx,besy,cftz,xyzio->adrbescftio", *maps, w)
    # -> (qx,qy,qz, dx,dy,dz,ci, rx,ry,rz,co)
    wp = wp.permute(0, 3, 6, 1, 4, 7, 9, 2, 5, 8, 10)
    Kx, Ky, Kz = (m.shape[0] for m in maps)
    return wp.reshape(Kx, Ky, Kz, f**3 * ci, f**3 * co)


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
