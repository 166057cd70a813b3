"""Spatial partitioning: X-slabs of every patch and the conv halos between
them (counterpart of the halo exchanges GSPMD inserts where JAX's dp x sp
mesh shards a conv's input over its ``space`` axis,
``contrast_gan_3d_tpu/parallel/mesh.py`` ``dp_sp_mesh`` / ``batch_spec``).

Under a :class:`~contrast_gan_3d_tpu_torch.parallel.mesh.DataMesh` with
``space`` S > 1 the S ranks of a data index hold the same samples, each the
rows ``bounds(n, S, index)`` of the first spatial dim (X, dim 2 of an
NCDHW activation, or of an NCHW slice of the 2D family) of every tensor
whose global extent there is n. A conv
layer computes the output rows its rank holds: it asks for the input rows
those read (``conv_window`` / ``tconv_window``), gets them from its own
slab, from the other ranks' slabs (the halo) and, outside ``[0, n)``, from
the layer's padding (``halo_extend``), and runs VALID along X on that
extended slab (padded along the other spatial dims as on one device). Reflect padding
therefore happens only at the global ends of X, on the first and the last
slab; every interior boundary takes the neighbour's voxels, and a slab
narrower than the halo takes rows from beyond its neighbour. The packed
layout's tensors are channels-last space-to-depth blocks, and there the
rows are block rows along dim 1 (``ops/packed.packed_conv3d_slab``).

The exchange is one ``all_reduce`` over the space group: each rank writes
the rows the others asked of it into their slots of a zeroed buffer, so
every slot is one rank's rows plus zeros, which is exact. Its backward
sends the halo rows' gradients back to their owners and adds them to the
owners' rows (``_HaloScatter``); the two Functions are each other's
backward, so the gradient penalty's double backward runs through them.
The plans are pure functions of the global extent, the windows and the
padding, the same on every rank, so every rank makes the same collectives
in the same order; an all-reduce is also what an NCCL CUDA graph captures.

A rank whose slab of a layer's output is empty (a deep critic layer with
fewer rows than ranks) computes one phantom row and keeps none of it, so
that its graph and its collectives are those of the other ranks.
"""

from functools import lru_cache
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

SLAB_DIM = 2  # X of an NCDHW activation (H of an NCHW slice)


def bounds(n: int, parts: int, index: int) -> Tuple[int, int]:
    """Rows ``[lo, hi)`` of a global extent ``n`` that part ``index`` of
    ``parts`` holds: ``index * n // parts`` up to the next part's start."""
    return index * n // parts, (index + 1) * n // parts


def conv_rows(n: int, k: int, s: int, p: int) -> int:
    """Output extent of a conv (kernel k, stride s, padding p) over n."""
    return (n + 2 * p - k) // s + 1


def conv_window(o0: int, o1: int, k: int, s: int, p: int) -> Tuple[int, int]:
    """The input rows ``[lo, hi)`` (global, padding outside ``[0, n)``)
    that the conv's outputs ``[o0, o1)`` read."""
    return o0 * s - p, (o1 - 1) * s - p + k


def tconv_window(o0: int, o1: int, k: int, s: int, offset: int) -> Tuple[int, int]:
    """The input rows ``[lo, hi)`` that the outputs ``[o0, o1)`` of a
    size-preserving transpose conv read, its window starting at
    ``offset`` of the full transpose conv (output o is full[o + offset],
    full[t] sums x[i] w[t - s i] over 0 <= t - s i < k)."""
    return -(-(o0 + offset - k + 1) // s), (o1 - 1 + offset) // s + 1


def _source(g: int, n: int, mode: str) -> Optional[int]:
    """The global row that padded row ``g`` copies, or None for a zero."""
    if 0 <= g < n:
        return g
    if mode == "reflect":
        r = -g if g < 0 else 2 * (n - 1) - g
        if 0 <= r < n:
            return r
    return None


class Plan(NamedTuple):
    """One rank's share of one exchange: ``sends`` (local row, slot,
    count) runs it writes, ``recv`` (slot, count) of the rows it reads,
    ``total`` slots, ``pieces`` (kind, start, count, step) runs that build
    the extended slab from "local" rows, "recv" rows or "zero" rows
    (step -1: a reflected run, ``start`` its first row), and the rows
    ``n_local`` it holds."""

    sends: Tuple[Tuple[int, int, int], ...]
    recv: Tuple[int, int]
    total: int
    pieces: Tuple[Tuple[str, int, int, int], ...]
    n_local: int

    def gather(self, x: torch.Tensor, group, dim: int) -> torch.Tensor:
        """The rows the other ranks hold that this rank asked for."""
        shape = list(x.shape)
        shape[dim] = self.total
        buf = x.new_zeros(shape)
        for local, slot, count in self.sends:
            buf.narrow(dim, slot, count).copy_(x.narrow(dim, local, count))
        dist.all_reduce(buf, group=group)
        return buf.narrow(dim, *self.recv)

    def scatter(self, g: torch.Tensor, group, dim: int) -> torch.Tensor:
        """The adjoint of :meth:`gather`: the received rows' gradients back
        at the rows they came from, summed where several ranks read one."""
        shape = list(g.shape)
        shape[dim] = self.total
        buf = g.new_zeros(shape)
        buf.narrow(dim, *self.recv).copy_(g)
        dist.all_reduce(buf, group=group)
        shape[dim] = self.n_local
        out = g.new_zeros(shape)
        for local, slot, count in self.sends:
            out.narrow(dim, local, count).add_(buf.narrow(dim, slot, count))
        return out


def _runs(items: Sequence[Tuple[str, int]]) -> List[Tuple[str, int, int, int]]:
    """(kind, index) per row -> (kind, start, count, step) runs."""
    runs: List[list] = []
    for kind, index in items:
        if runs:
            last = runs[-1]
            if last[0] == kind == "zero":
                last[2] += 1
                continue
            if last[0] == kind:
                step = index - (last[1] + (last[2] - 1) * last[3])
                if step in (1, -1) and (last[2] == 1 or step == last[3]):
                    last[3], last[2] = step, last[2] + 1
                    continue
        runs.append([kind, index, 1, 1])
    return [tuple(r) for r in runs]


@lru_cache(maxsize=1024)
def plan(n: int, space: int, index: int, windows: Tuple[Tuple[int, int], ...], mode: str) -> Plan:
    """Rank ``index``'s :class:`Plan` for an exchange over a global extent
    ``n`` split in ``space`` slabs, rank q asking for rows
    ``windows[q]``, padded by ``mode`` ("zeros" or "reflect") outside
    ``[0, n)``."""
    owned = [bounds(n, space, q) for q in range(space)]
    remote, offsets, total = [], [], 0
    for q, (lo, hi) in enumerate(windows):
        rows = {_source(g, n, mode) for g in range(lo, hi)} - {None}
        remote.append(sorted(r for r in rows if not owned[q][0] <= r < owned[q][1]))
        offsets.append(total)
        total += len(remote[q])
    mine_lo, mine_hi = owned[index]
    sends = []
    for q in range(space):
        if q == index:
            continue
        for pos, r in enumerate(remote[q]):
            if mine_lo <= r < mine_hi:
                slot, local = offsets[q] + pos, r - mine_lo
                if sends and sends[-1][0] + sends[-1][2] == local and sends[-1][1] + sends[-1][2] == slot:
                    sends[-1][2] += 1
                else:
                    sends.append([local, slot, 1])
    position = {r: i for i, r in enumerate(remote[index])}
    items = []
    for g in range(*windows[index]):
        r = _source(g, n, mode)
        if r is None:
            items.append(("zero", 0))
        elif mine_lo <= r < mine_hi:
            items.append(("local", r - mine_lo))
        else:
            items.append(("recv", position[r]))
    return Plan(tuple(tuple(s) for s in sends), (offsets[index], len(remote[index])), total,
                tuple(_runs(items)), mine_hi - mine_lo)


class _HaloGather(torch.autograd.Function):
    """``plan.gather``; its backward is :class:`_HaloScatter`."""

    @staticmethod
    def forward(ctx, x, plan_: Plan, group, dim: int):
        ctx.plan, ctx.group, ctx.dim = plan_, group, dim
        return plan_.gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _HaloScatter.apply(g, ctx.plan, ctx.group, ctx.dim), None, None, None


class _HaloScatter(torch.autograd.Function):
    """``plan.scatter``; its backward is :class:`_HaloGather`."""

    @staticmethod
    def forward(ctx, g, plan_: Plan, group, dim: int):
        ctx.plan, ctx.group, ctx.dim = plan_, group, dim
        return plan_.scatter(g, group, dim)

    @staticmethod
    def backward(ctx, gg):
        return _HaloGather.apply(gg, ctx.plan, ctx.group, ctx.dim), None, None, None


def halo_extend(x: torch.Tensor, mesh, n: int, windows: Sequence[Tuple[int, int]], mode: str = "zeros",
                dim: int = SLAB_DIM) -> torch.Tensor:
    """Rows ``windows[mesh.space_index]`` of the global tensor (extent
    ``n`` along ``dim``) whose slab this rank holds in ``x``: its own rows,
    the halo from the others (a collective: every rank of the space group
    calls it with the same ``n``, ``windows`` and ``mode``) and, outside
    ``[0, n)``, ``mode`` padding. Differentiable, twice."""
    p = plan(n, mesh.space, mesh.space_index, tuple(windows), mode)
    if x.shape[dim] != p.n_local:
        raise ValueError(f"a slab of {x.shape[dim]} rows along dim {dim}; this rank holds {p.n_local} of {n}")
    recv = _HaloGather.apply(x, p, mesh.space_group, dim) if p.total else None
    parts = []
    for kind, start, count, step in p.pieces:
        if kind == "zero":
            shape = list(x.shape)
            shape[dim] = count
            parts.append(x.new_zeros(shape))
            continue
        src = x if kind == "local" else recv
        part = src.narrow(dim, start if step == 1 else start - count + 1, count)
        parts.append(part if step == 1 else part.flip(dim))
    if recv is not None and not any(kind == "recv" for kind, *_ in p.pieces):
        parts.append(recv)  # no rows, but the exchange's backward runs on every rank
    return torch.cat(parts, dim) if len(parts) > 1 else parts[0]


def halo_input(x: torch.Tensor, mesh, n: int, n_out: int, window: Callable[[int, int], Tuple[int, int]],
               mode: str = "zeros", dim: int = SLAB_DIM) -> Tuple[torch.Tensor, Tuple[int, int], int]:
    """For a layer whose output has the global extent ``n_out``: this
    rank's output rows ``(o0, o1)``, ``x`` extended along ``dim`` to the
    input rows ``window(o0, o1)`` they read (:func:`halo_extend`), and
    that window's first row. A rank with no output rows asks for one
    phantom row's window (its caller keeps none of that row). The rows
    may be voxels or, in the packed layout, blocks (dim 1)."""
    windows = []
    for q in range(mesh.space):
        o0, o1 = bounds(n_out, mesh.space, q)
        windows.append(window(o0, max(o1, o0 + 1)))
    out = bounds(n_out, mesh.space, mesh.space_index)
    return halo_extend(x, mesh, n, windows, mode, dim), out, windows[mesh.space_index][0]


def split_slab(x: torch.Tensor, mesh, dim: int = SLAB_DIM) -> torch.Tensor:
    """This rank's slab of a whole tensor ``x`` along ``dim`` (a view)."""
    lo, hi = mesh.slab(x.shape[dim])
    return x if (lo, hi) == (0, x.shape[dim]) else x.narrow(dim, lo, hi - lo)


def gather_slab(x: torch.Tensor, mesh, n: int, dim: int = SLAB_DIM) -> torch.Tensor:
    """The whole tensor (extent ``n`` along ``dim``) from the space
    group's slabs, this rank's ``x`` among them (a collective, no
    gradient)."""
    if mesh.space == 1:
        return x
    shape = list(x.shape)
    shape[dim] = n
    buf = x.detach().new_zeros(shape)
    lo, hi = mesh.slab(n)
    buf.narrow(dim, lo, hi - lo).copy_(x.detach())
    dist.all_reduce(buf, group=mesh.space_group)
    return buf
