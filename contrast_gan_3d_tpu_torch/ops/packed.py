"""Block-space ("packed") 3D convolution pipeline (counterpart of
``contrast_gan_3d_tpu/ops/packed.py``).

Activations stay in space-to-depth block layout (``ops/s2d_conv.
space_to_depth`` order) across stage boundaries, and every full-resolution
conv runs as a dense VALID block-space conv:

- ``packed_conv3d``: input packed ``f_in``, output packed ``f_out``,
  original stride ``s`` (the block stride ``s*f_out/f_in`` must be a
  positive integer). Torch-style zero padding ``p`` per side is exact: the
  input is padded with whole zero blocks and the sub-block offset ``o =
  L*f_in - p`` is folded into the transformed kernel (``A[q,d,r,T] =
  [f_in*q + d == s*r + T + o]`` per axis), so taps beyond the true pad
  have zero weight.
- ``reflect_pad_packed``: reflect padding built in packed space from
  channel-axis flips and block-level slices of the boundary blocks; no
  full-resolution round trip. Slices, flips and concatenations only: its
  backward repeats bit for bit (no atomics).
- ``packed_tconv3d`` / ``packed_tconv3d_f4``: the stride-2 transpose conv
  as a forward stride-1 (stride-2) conv whose output channels are the
  f2 (f4) packed phases: no transpose-conv kernel, no depth-to-space; the
  torch placement's one-voxel shift is one more block tap in the kernel.
- ``packed_affine``, ``repack`` / ``unpack_repack``: per-channel
  multiply-add and block-factor changes on packed tensors.
- ``packed_conv3d_padded`` and ``packed_tconv3d`` take a ``mesh``: under
  spatial partitioning each rank holds an X-slab of block rows and the
  convs exchange their halos in block rows (``parallel/spatial.py``),
  the reflect pad rebuilt at the global ends only (``reflect_slab_ends``).

Tensors are the JAX package's channels-last ``(B, X, Y, Z, f^3*C)`` with
the ``(dx, dy, dz, c)`` d-major channel order; kernels ``(k, k, k, Ci,
Co)`` in flax's layout. Convs are ``F.conv3d`` on permuted views
(``ops/s2d_conv.conv3d_cl``), in x's dtype. The transformed kernels are 0/1
scatters of the true weights, built every call from device aranges (no
host copy inside a captured CUDA graph) with one contraction per axis, so
autograd yields the true weights' gradients and the parameters keep their
shapes.
"""

from typing import Optional, Sequence, Tuple

import torch

from contrast_gan_3d_tpu_torch.ops.s2d_conv import _tconv_axis_map_tensor, conv3d_cl, zero_pad_cl
from contrast_gan_3d_tpu_torch.parallel.mesh import LOCAL
from contrast_gan_3d_tpu_torch.parallel.spatial import conv_window, halo_input


def _packed_K(k: int, f_in: int, f_out: int, s: int, o: int) -> int:
    return (s * (f_out - 1) + k - 1 + o) // f_in + 1


def _axis_map_packed_tensor(k: int, f_in: int, f_out: int, s: int, o: int, dtype, device) -> torch.Tensor:
    """(K, f_in, f_out, k) 0/1 tensor A[q, d, r, T] = [f_in*q + d == s*r + T + o]
    (the JAX package's ``_axis_map_packed``), built on ``device`` from
    aranges: output voxel x = f_out*X + r reads padded-input index s*x + T +
    o, which lies in block b*X + q (b = s*f_out/f_in) at position d."""
    K = _packed_K(k, f_in, f_out, s, o)
    idx = lambda n: torch.arange(n, device=device)
    q, d, r, T = idx(K)[:, None, None, None], idx(f_in)[:, None, None], idx(f_out)[:, None], idx(k)
    return (f_in * q + d == s * r + T + o).to(dtype)


def transform_kernel_packed(
    w: torch.Tensor, f_in: int, f_out: int, s: int = 1, o: Sequence[int] = (0, 0, 0)
) -> torch.Tensor:
    """(kx,ky,kz,Ci,Co) true kernel -> (Kx,Ky,Kz, f_in^3*Ci, f_out^3*Co)
    block-space kernel; input channels (dx,dy,dz,ci) d-major, output
    (rx,ry,rz,co) r-major."""
    kx, ky, kz, ci, co = w.shape
    Ax, Ay, Az = (_axis_map_packed_tensor(k, f_in, f_out, s, int(oo), w.dtype, w.device)
                  for k, oo in zip((kx, ky, kz), o))
    # one 0/1 contraction per axis (a four-operand einsum would build the
    # outer product of the maps first, k^3 times the kernel's size)
    wp = torch.einsum("adrx,xyzio->adryzio", Ax, w)
    wp = torch.einsum("besy,adryzio->adrbeszio", Ay, wp)
    wp = torch.einsum("cftz,adrbeszio->abcdefirsto", Az, wp)
    return wp.reshape(Ax.shape[0], Ay.shape[0], Az.shape[0], f_in**3 * ci, f_out**3 * co)


def _channel_view(xp: torch.Tensor, f: int, c: int) -> torch.Tensor:
    return xp.reshape(*xp.shape[:4], f, f, f, c)


def _block_flip(xp: torch.Tensor, f: int, c: int, axis: int) -> torch.Tensor:
    """Full-resolution flip of a packed tensor along spatial ``axis``: the
    block order and the within-block position on that axis."""
    v = _channel_view(xp.flip(1 + axis), f, c).flip(4 + axis)
    return v.reshape(xp.shape)


def _set_slice(v: torch.Tensor, val: torch.Tensor, axis: int, index: int) -> torch.Tensor:
    parts = []
    n = v.shape[axis]
    if index > 0:
        parts.append(v.narrow(axis, 0, index))
    parts.append(val)
    if index + 1 < n:
        parts.append(v.narrow(axis, index + 1, n - index - 1))
    return torch.cat(parts, axis)


def _roll_one(xp: torch.Tensor, f: int, c: int, axis: int, backward: bool = False) -> torch.Tensor:
    """Shift a packed tensor by one full-resolution voxel along ``axis``
    (circular at block granularity: callers read only where the wrap is
    never read). Forward: out[pos] = x[pos - 1]; backward: x[pos + 1]."""
    v = _channel_view(xp, f, c)
    pax, vax = 1 + axis, 4 + axis
    if not backward:
        # within-block r takes r-1; r = 0 takes the previous block's f-1
        shifted = torch.roll(v, 1, vax)
        first = torch.roll(shifted.narrow(vax, 0, 1), 1, pax)
        shifted = _set_slice(shifted, first, vax, 0)
    else:
        shifted = torch.roll(v, -1, vax)
        last = torch.roll(shifted.narrow(vax, f - 1, 1), -1, pax)
        shifted = _set_slice(shifted, last, vax, f - 1)
    return shifted.reshape(xp.shape)


def reflect_pad_packed(
    xp: torch.Tensor, f: int, p: int, axes: Sequence[int] = (0, 1, 2)
) -> Tuple[torch.Tensor, int]:
    """Reflect-pad a packed (B, X, Y, Z, f^3*C) tensor by ``p`` full-res
    voxels per side along each axis, in packed space. Pads whole blocks:
    L = ceil(p/f) per side; the leading ``o = L*f - p`` positions of the
    left pad hold values a ``packed_conv3d(..., o=o)`` never reads. Returns
    (padded, o). Per axis, from the (L+1)-block boundary slabs only:

      left pad[j]  = x[L*f - j]  = roll_fwd(flip(head))[f + j] -> blocks [1, 1+L)
      right pad[j] = x[N*f-2-j]  = roll_bwd(flip(tail))[j]     -> blocks [0, L)

    The padded tensor is written once: a zero pad of every axis, then the
    slabs copied into it axis by axis, each taken from the axes padded
    before it (the corners reflect twice, as sequential pads do)."""
    c = xp.shape[-1] // f**3
    L = -(-p // f)
    o = L * f - p
    for axis in axes:
        if xp.shape[1 + axis] < L + 1:
            raise ValueError(f"axis {axis}: {xp.shape[1 + axis]} blocks < L+1={L + 1}")
    out = zero_pad_cl(xp, [(L, L) if a in axes else (0, 0) for a in range(3)])
    done = set()
    for axis in axes:
        dim = 1 + axis
        # the region this axis pads: all of the axes padded before it, the
        # interior of the others
        view = out
        for a in range(3):
            if a != axis and a in axes and a not in done:
                view = view.narrow(1 + a, L, xp.shape[1 + a])
        n_blocks = xp.shape[dim]
        view.narrow(dim, 0, L).copy_(reflect_blocks(view.narrow(dim, L, n_blocks), f, L, "left", axis))
        view.narrow(dim, L + n_blocks, L).copy_(reflect_blocks(view.narrow(dim, L, n_blocks), f, L, "right", axis))
        done.add(axis)
    return out, o


def reflect_blocks(xp: torch.Tensor, f: int, L: int, side: str, axis: int = 0) -> torch.Tensor:
    """The ``L`` reflect-pad blocks on ``side`` ("left" or "right") of a
    packed tensor along spatial ``axis`` (:func:`reflect_pad_packed`'s
    pads of p = L*f - o voxels), from its (L+1)-block boundary slab on that
    side alone: what the first or the last X-slab of a spatially
    partitioned tensor pads with at the global end it holds."""
    dim, c = 1 + axis, xp.shape[-1] // f**3
    if xp.shape[dim] < L + 1:
        raise ValueError(f"axis {axis}: {xp.shape[dim]} blocks < L+1={L + 1}")
    if side == "left":
        head = xp.narrow(dim, 0, L + 1)
        return _roll_one(_block_flip(head, f, c, axis), f, c, axis).narrow(dim, 1, L)
    tail = xp.narrow(dim, xp.shape[dim] - (L + 1), L + 1)
    return _roll_one(_block_flip(tail, f, c, axis), f, c, axis, backward=True).narrow(dim, 0, L)


def _add_tiled_bias(out: torch.Tensor, bias: Optional[torch.Tensor], f: int) -> torch.Tensor:
    """The true bias added to every one of the f^3 packed positions, in
    out's dtype (the JAX package's ``jnp.tile``)."""
    return out if bias is None else out + bias.to(out.dtype).repeat(f**3)


def packed_conv3d(
    xp: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    f_in: int,
    f_out: int,
    stride: int = 1,
    pad: int = 0,
    out_blocks: Tuple[int, int, int],
    o: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """A torch-padded 3D conv executed as a VALID block-space conv.

    xp: (B, Xb, Yb, Zb, f_in^3*Ci) packed; w: (k, k, k, Ci, Co) the true
    kernel (f32 parameters are cast to xp's dtype after the transform).
    ``pad``: zero padding per side at full resolution, ignored when ``o`` is
    given (the input is then already padded, e.g. by
    :func:`reflect_pad_packed`, with alignment offset ``o``).
    ``out_blocks``: the output's block dims. Output (B, *out_blocks,
    f_out^3*Co) in xp's dtype."""
    b_stride = stride * f_out
    if b_stride % f_in:
        raise ValueError(f"block stride {stride}*{f_out}/{f_in} is not an integer")
    b_stride //= f_in
    if o is None:
        # zero-pad whole blocks; the offset goes into the kernel
        L = -(-pad // f_in)
        if L:
            xp = zero_pad_cl(xp, [(L, L)] * 3)
        o3 = (L * f_in - pad,) * 3
    else:
        o3 = tuple(int(v) for v in o)
    wp = transform_kernel_packed(w, f_in, f_out, stride, o3).to(xp.dtype)
    K = wp.shape[:3]
    # right-extend with zero blocks where the VALID conv needs more input
    # (never read with a nonzero weight)
    extra = [max(0, (out_blocks[i] - 1) * b_stride + K[i] - xp.shape[1 + i]) for i in range(3)]
    if any(extra):
        xp = zero_pad_cl(xp, [(0, e) for e in extra])
    out = conv3d_cl(xp, wp, b_stride)
    out = out[:, : out_blocks[0], : out_blocks[1], : out_blocks[2]]
    return _add_tiled_bias(out, bias, f_out)


def packed_tconv3d(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 2,
    convention: str = "same",
    mesh=LOCAL,
) -> torch.Tensor:
    """Stride-s transpose conv, unpacked input (B, X, Y, Z, Ci), packed
    f=s output (B, X, Y, Z, s^3*Co): ``ops/s2d_conv.d2s_tconv3d`` without
    its depth-to-space (the (rx,ry,rz,co) output channels are the f=s
    ``space_to_depth`` layout of the full-resolution result). The "torch"
    convention's window full[1 : sN+1] is folded into the kernel (one more
    block tap per axis, :func:`_tconv_phase_map_tensor`) where the JAX
    package shifts the output by one voxel in packed space: the same
    products, without three passes over the output.

    Under spatial partitioning (``mesh.space`` > 1) x is this rank's
    X-slab (equal slabs) and so is the output, whose block rows are x's
    rows: the forward conv reads Km block taps from ``K - 1`` rows before
    each output row (Km - K more after it: the torch placement's shift is
    one of them), the rows beyond the slab through
    ``parallel/spatial.halo_input`` on dim 1, zeros beyond the global
    ends."""
    if mesh.space == 1:
        return _packed_tconv(x, w, bias, stride, 1, convention)
    n = x.shape[1] * mesh.space
    K = (w.shape[0] - 1) // stride + 1
    Km = K + (stride - 1 + int(convention == "torch")) // stride
    ext, (o0, o1), _ = halo_input(x, mesh, n, n, lambda a, b: conv_window(a, b, Km, 1, K - 1), dim=1)
    return _packed_tconv(ext, w, bias, stride, 1, convention, pad_x=False).narrow(1, 0, o1 - o0)


def _tconv_phase_map_tensor(k: int, s: int, m: int, shift: int, dtype, device) -> torch.Tensor:
    """(Km, m*s, k) map of a stride-s transpose conv whose output is packed
    f = m*s: C[t, d, T] takes the base map A[j, r, T] (``ops/s2d_conv.
    _tconv_axis_map``) at block tap t = a + j, where the f-digit position d
    (+ ``shift``, 1 for the torch window full[1 : sN+1]) splits as (a, r) =
    divmod(d + shift, s). Km = K + (m*s - 1 + shift) // s."""
    A = _tconv_axis_map_tensor(k, s, dtype, device)  # (K, s, k)
    K = A.shape[0]
    Km = K + (m * s - 1 + shift) // s
    pos = torch.arange(m * s, device=device) + shift
    a, r = pos // s, pos % s
    t, j = torch.arange(Km, device=device)[:, None, None], torch.arange(K, device=device)[None, :, None]
    sel = (t == a + j).to(dtype)  # (Km, K, m*s)
    return torch.einsum("tjd,jdx->tdx", sel, A[:, r, :])


def _packed_tconv(x, w, bias, s: int, m: int, convention: str, pad_x: bool = True) -> torch.Tensor:
    """The transpose conv as one stride-m conv of x padded by (K-1, shift)
    whose output channels are the (m*s)^3 phases, (dx, dy, dz, co).
    ``pad_x`` False: x's first spatial dim is already extended (an X-slab
    with its halo), so only Y and Z are padded."""
    if convention not in ("same", "torch"):
        raise ValueError(f"unknown convention {convention!r}")
    kx, ky, kz, ci, co = w.shape
    shift = int(convention == "torch")
    K = (kx - 1) // s + 1
    Cx, Cy, Cz = (_tconv_phase_map_tensor(k, s, m, shift, w.dtype, w.device) for k in (kx, ky, kz))
    wp = torch.einsum("aux,xyzio->auyzio", Cx, w)
    wp = torch.einsum("bvy,auyzio->aubvzio", Cy, wp)
    wp = torch.einsum("cwz,aubvzio->abciuvwo", Cz, wp)
    f = m * s
    wp = wp.reshape(Cx.shape[0], Cy.shape[0], Cz.shape[0], ci, f**3 * co).to(x.dtype)
    pads = [(K - 1, shift)] * 3
    out = conv3d_cl(zero_pad_cl(x, pads if pad_x else [(0, 0)] + pads[1:]), wp, m)
    return _add_tiled_bias(out, bias, f)


def packed_tconv3d_f4(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 2,
    convention: str = "same",
) -> torch.Tensor:
    """Stride-s transpose conv, unpacked input, f=2s packed output
    (B, X/2, Y/2, Z/2, (2s)^3*Co): :func:`packed_tconv3d` with a 2^3
    neighbourhood of s-blocks absorbed into the channels (a stride-2 block
    conv), so the consumer gets the f4 layout without a repack. Spatial
    dims must be even."""
    if any(d % 2 for d in x.shape[1:4]):
        raise ValueError(f"spatial dims {tuple(x.shape[1:4])} must be even")
    return _packed_tconv(x, w, bias, stride, 2, convention)


def repack(xp: torch.Tensor, f: int, m: int, c: int) -> torch.Tensor:
    """(B, mX, mY, mZ, f^3*c) f-packed -> (B, X, Y, Z, (m*f)^3*c) mf-packed:
    an m^3 block neighbourhood absorbed into the channels (a transpose)."""
    b, Xm, Ym, Zm, _ = xp.shape
    X, Y, Z = Xm // m, Ym // m, Zm // m
    v = xp.reshape(b, X, m, Y, m, Z, m, f, f, f, c)
    # -> (b, X, Y, Z, ax, dx, ay, dy, az, dz, c)
    v = v.permute(0, 1, 3, 5, 2, 7, 4, 8, 6, 9, 10)
    return v.reshape(b, X, Y, Z, (m * f) ** 3 * c)


def unpack_repack(xp: torch.Tensor, f: int, m: int, c: int) -> torch.Tensor:
    """Inverse of :func:`repack`: mf-packed -> f-packed."""
    b, X, Y, Z, _ = xp.shape
    v = xp.reshape(b, X, Y, Z, m, f, m, f, m, f, c)
    # -> (b, X, ax, Y, ay, Z, az, dx, dy, dz, c)
    v = v.permute(0, 1, 4, 2, 6, 3, 8, 5, 7, 9, 10)
    return v.reshape(b, X * m, Y * m, Z * m, f**3 * c)


def packed_affine(xp: torch.Tensor, f: int, mult: torch.Tensor, add: torch.Tensor) -> torch.Tensor:
    """Per-true-channel y = x*mult + add on a packed tensor (BatchNorm's
    inference collapse), the (C,) vectors tiled over the f^3 positions."""
    return xp * mult.to(xp.dtype).repeat(f**3) + add.to(xp.dtype).repeat(f**3)


def packed_conv3d_padded(
    xp: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor],
    *,
    f_in: int,
    f_out: int,
    stride: int = 1,
    pad: int = 0,
    mode: str = "zeros",
    mesh=LOCAL,
) -> torch.Tensor:
    """:func:`packed_conv3d` of ``xp`` padded by ``pad`` voxels per side
    with zeros (``mode="reflect"``: reflected, :func:`reflect_pad_packed`),
    whose output has ``d * f_in // (stride * f_out)`` blocks for ``d`` input
    blocks along each axis: the packed generator's stages.

    Under spatial partitioning (``mesh.space`` > 1) ``xp`` is this rank's
    X-slab of block rows (dim 1; equal slabs) and so is the output. The
    VALID block conv's window is K block taps at block stride ``stride *
    f_out / f_in`` (the direct conv's window in block units): the rows it
    reads from the other slabs come through ``parallel/spatial.halo_input``
    on dim 1, and only the first and the last slab pad along X, a reflect
    pad from their own (L+1)-block boundary slab (:func:`reflect_slab_ends`).
    Y and Z pad as without a mesh. Differentiable, twice."""
    out_blocks = tuple(d * f_in // (stride * f_out) for d in xp.shape[1:4])
    if mesh.space == 1:
        if mode == "zeros":
            return packed_conv3d(xp, w, bias, f_in=f_in, f_out=f_out, stride=stride, pad=pad, out_blocks=out_blocks)
        xp, o = reflect_pad_packed(xp, f_in, pad)
        return packed_conv3d(xp, w, bias, f_in=f_in, f_out=f_out, stride=stride, o=(o, o, o), out_blocks=out_blocks)
    n = xp.shape[1] * mesh.space
    L = -(-pad // f_in)
    o = L * f_in - pad
    K, b_stride = _packed_K(w.shape[0], f_in, f_out, stride, o), stride * f_out // f_in
    ext, (o0, o1), lo = halo_input(xp, mesh, n, n * f_in // (stride * f_out),
                                   lambda a, b: conv_window(a, b, K, b_stride, L), dim=1)
    if mode == "reflect":
        ext, _ = reflect_pad_packed(reflect_slab_ends(ext, xp, f_in, L, lo, n), f_in, pad, axes=(1, 2))
    elif L:
        ext = zero_pad_cl(ext, [(0, 0), (L, L), (L, L)])
    # a rank without output rows computes a phantom one and keeps none
    y = packed_conv3d(ext, w, bias, f_in=f_in, f_out=f_out, stride=stride,
                      out_blocks=(max(o1 - o0, 1), *out_blocks[1:]), o=(o, o, o))
    return y.narrow(1, 0, o1 - o0)


def reflect_slab_ends(ext: torch.Tensor, slab: torch.Tensor, f: int, L: int, lo: int, n: int) -> torch.Tensor:
    """``ext``, the block rows ``[lo, lo + ext.shape[1])`` of a packed
    tensor of ``n`` block rows that this rank's ``slab`` extends (zero
    blocks outside ``[0, n)``), with those zero blocks replaced by the
    reflect pad of ``L`` blocks (:func:`reflect_pad_packed` along X): the
    first and the last slab build it from their own (L+1)-block boundary
    slab; the others pad nothing."""
    left, right = max(0, -lo), max(0, lo + ext.shape[1] - n)
    if not (left or right):
        return ext
    if max(left, right) != L:
        raise ValueError(f"a slab of {slab.shape[1]} block rows pads {left} / {right} blocks, not {L}")
    parts = [reflect_blocks(slab, f, L, "left")] if left else []
    parts.append(ext.narrow(1, left, ext.shape[1] - left - right))
    if right:
        parts.append(reflect_blocks(slab, f, L, "right"))
    return torch.cat(parts, 1)
