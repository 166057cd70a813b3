"""Data parallelism and spatial partitioning over ``torch.distributed``
(counterpart of ``contrast_gan_3d_tpu/parallel/mesh.py``).

The JAX package drives N devices from one process: GSPMD shards every batch
over a ``data`` mesh axis (and, on a dp x sp mesh, the first spatial dim of
every patch over a ``space`` axis) and inserts the collectives. The port
runs one process (a rank) per device in a process group (NCCL on the card,
gloo on the CPU), and a :class:`DataMesh` says which share of each batch a
rank owns and carries the collectives the steps need:

- batches: every rank of a host loads the same host batch (on one host:
  the global batch, the batches a one-device run trains on) and keeps the
  contiguous slice ``batch_slice`` gives its DATA index, the share
  ``put_batch`` gives a device in JAX. The global batch is the
  concatenation of the hosts' batches in data-rank order, so data rank d's
  first sample is global sample ``d * n_local``;
- space (``space`` S > 1, :func:`dp_sp_mesh`): the ranks are a D x S grid,
  ``rank = data_index * S + space_index`` (space the minor axis, as in
  JAX). The S ranks of a data index hold the same samples, each an X-slab
  of them (``slab``, the first spatial dim), and the models exchange conv
  halos between them (``parallel/spatial.py``); ``space_sum`` sums over
  them;
- reductions: ``all_sum`` is a differentiable all-reduce over every rank
  whose backward is the all-reduce of the incoming gradients, so a loss
  built from global statistics (BatchNorm's, the losses' means) has its
  gradient on every rank, and every rank's backward computes the gradient
  of the sum of the ranks' (equal) losses: ``world_size`` times the
  single-device gradient in total. ``reduce_gradients`` therefore
  all-reduces the parameters' gradients and divides by ``world_size``.
  ``space_sum`` and the halo exchange are differentiable the same way, so
  the convention holds under spatial partitioning too;
- ``pad_batch_to_multiple`` pads an evaluation batch to the data ranks of
  a host with validity weights (JAX's ``pad_batch_to_multiple``).

One device without a process group is :data:`LOCAL`, a :class:`LocalMesh`
whose collectives are identities and whose space axis has one rank: the
steps, the losses and BatchNorm always run over a mesh, and over ``LOCAL``
they are the single-device computation.
"""

import os
import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from contrast_gan_3d_tpu_torch.parallel.spatial import bounds


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group's ranks; its backward is itself (a sum of the
    incoming gradients), so it differentiates twice (the gradient penalty's
    double backward)."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = t.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _AllReduceSum.apply(g, ctx.group), None


@dataclass(frozen=True)
class DataMesh:
    """The ranks of a process group, one device each: ``world_size // space``
    data-parallel ranks, each of ``space`` ranks that split its patches
    along the first spatial dim (``space`` 1: data parallelism alone).

    ``hosts`` is the number of loader groups: ranks ``[h * L, (h + 1) * L)``
    (``L = world_size // hosts``, whole space groups) share host ``h``'s
    loaders and split each of its batches over their data indices.
    ``group`` None is the default group; ``data_group`` / ``space_group``
    are this rank's subgroups of the same data index / space index
    (:func:`dp_sp_mesh` makes them; None with ``space`` 1)."""

    rank: int
    world_size: int
    device: torch.device
    hosts: int = 1
    group: Optional[dist.ProcessGroup] = None
    space: int = 1
    data_group: Optional[dist.ProcessGroup] = None
    space_group: Optional[dist.ProcessGroup] = None

    def __post_init__(self):
        if self.world_size % self.space:
            raise ValueError(f"{self.world_size} ranks do not form a grid with {self.space} spatial ranks")
        if self.data_size % self.hosts:
            raise ValueError(f"{self.data_size} data-parallel ranks do not split over {self.hosts} hosts")

    @property
    def capturable(self) -> bool:
        """Whether the group's collectives can be captured in a CUDA graph
        (NCCL's can; gloo's cannot)."""
        return dist.get_backend(self.group) == "nccl"

    @property
    def data_size(self) -> int:
        return self.world_size // self.space

    @property
    def data_index(self) -> int:
        return self.rank // self.space

    @property
    def space_index(self) -> int:
        return self.rank % self.space

    @property
    def ranks_per_host(self) -> int:
        """The data-parallel ranks that split a host's batches."""
        return self.data_size // self.hosts

    @property
    def host_index(self) -> int:
        return self.data_index // self.ranks_per_host

    @property
    def local_index(self) -> int:
        """This rank's data index among the ranks that share its host's
        batches."""
        return self.data_index % self.ranks_per_host

    def batch_slice(self, n: int) -> slice:
        """This rank's share of a batch of ``n`` its host loaded."""
        per = n // self.ranks_per_host
        if n % self.ranks_per_host:
            raise ValueError(f"a batch of {n} does not split over the {self.ranks_per_host} data-parallel ranks of "
                             f"this host")
        return slice(self.local_index * per, (self.local_index + 1) * per)

    def global_slice(self, n_local: int) -> slice:
        """This rank's samples in the global batch, ``n_local`` per data
        rank."""
        return slice(self.data_index * n_local, (self.data_index + 1) * n_local)

    def slab(self, n: int) -> Tuple[int, int]:
        """The rows ``[lo, hi)`` of a global extent ``n`` along the first
        spatial dim that this rank holds."""
        return bounds(n, self.space, self.space_index)

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, differentiable (see the module
        docstring)."""
        return _AllReduceSum.apply(t, self.group)

    def space_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks that share this rank's samples,
        differentiable as ``all_sum``."""
        return t if self.space == 1 else _AllReduceSum.apply(t, self.space_group)

    def numel(self, t: torch.Tensor, rows: Optional[int] = None) -> int:
        """The element count of ``t`` summed over the ranks, from shapes
        alone: ``t.numel() * world_size`` where every rank holds an equal
        share (or, across a space group, the same per-sample values); with
        ``rows``, ``t`` is an X-slab (dim 2) of a global extent ``rows``,
        whose slabs need not be equal (the critic's logits)."""
        if rows is None:
            return t.numel() * self.world_size
        return t.shape[:2].numel() * rows * t.shape[3:].numel() * self.data_size

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The data ranks' ``t`` (of this space index) concatenated on dim 0,
        in rank order (no gradient)."""
        parts = [torch.empty_like(t) for _ in range(self.data_size)]
        dist.all_gather(parts, t.contiguous(), group=self.group if self.space == 1 else self.data_group)
        return torch.cat(parts)

    def reduce_gradients(self, grads: Sequence[torch.Tensor]) -> None:
        """Replace each gradient by its mean over the ranks, in place, with
        one all-reduce of a flattened buffer."""
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.group)
        flat.div_(self.world_size)
        offset = 0
        for g in grads:
            g.copy_(flat[offset : offset + g.numel()].view_as(g))
            offset += g.numel()

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank (a collective)."""
        t = torch.tensor([1.0 if flag else 0.0], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())

    def broadcast_module(self, module: torch.nn.Module) -> None:
        """Rank 0's parameters and buffers on every rank."""
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0, group=self.group)

    def barrier(self) -> None:
        dist.barrier(group=self.group)


class LocalMesh:
    """One device and no process group: rank 0 of 1, every collective an
    identity (the interface of :class:`DataMesh`)."""

    rank = host_index = local_index = data_index = space_index = 0
    world_size = hosts = ranks_per_host = data_size = space = 1
    capturable = True

    def batch_slice(self, n: int) -> slice:
        return slice(0, n)

    global_slice = batch_slice

    def slab(self, n: int) -> Tuple[int, int]:
        return 0, n

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        return t

    all_gather = space_sum = all_sum

    def numel(self, t: torch.Tensor, rows: Optional[int] = None) -> int:
        return t.numel()

    def reduce_gradients(self, grads: Sequence[torch.Tensor]) -> None:
        pass

    def any(self, flag: bool) -> bool:
        return flag

    def broadcast_module(self, module: torch.nn.Module) -> None:
        pass

    def barrier(self) -> None:
        pass


LOCAL = LocalMesh()


def data_mesh(
    n_devices: Optional[int] = None,
    device=None,
    hosts: int = 1,
    group: Optional[dist.ProcessGroup] = None,
) -> DataMesh:
    """The :class:`DataMesh` of this rank in the initialized process group:
    one rank per device, so ``n_devices`` (None or 0: every rank) must be the
    group's size; more is refused, as JAX's ``data_mesh`` refuses more
    devices than it has. ``device``: this rank's device (default
    :func:`local_device` for the group's backend), made the current CUDA
    device."""
    if not dist.is_initialized():
        raise RuntimeError("data_mesh needs an initialized torch.distributed process group (multihost.initialize, "
                           "or spawn_ranks)")
    world = dist.get_world_size(group)
    if n_devices and n_devices > world:
        raise ValueError(f"data_mesh(n_devices={n_devices}): only {world} ranks (one device each) in the process "
                         f"group")
    if n_devices and n_devices != world:
        raise ValueError(f"data_mesh(n_devices={n_devices}): the process group has {world} ranks; start one rank "
                         f"per device")
    device = torch.device(device) if device is not None else \
        local_device("cuda" if dist.get_backend(group) == "nccl" else "cpu")
    if device.type == "cuda":
        # NCCL's communicators and barriers take the current device
        torch.cuda.set_device(device)
    return DataMesh(dist.get_rank(group), world, device, hosts=hosts, group=group)


def dp_sp_mesh(n_data: int, n_space: int, device=None, hosts: int = 1) -> DataMesh:
    """The D x S :class:`DataMesh` of this rank in the initialized default
    process group (JAX's ``dp_sp_mesh``): ``n_data`` data-parallel ranks,
    each of ``n_space`` ranks that split its patches along the first
    spatial dim (space the minor axis: ranks ``d * S .. d * S + S - 1``
    share data index d). The group must hold exactly ``n_data * n_space``
    ranks. Every rank makes every data and space subgroup, in one order
    (``dist.new_group`` is a collective over the default group)."""
    if not dist.is_initialized():
        raise RuntimeError("dp_sp_mesh needs an initialized torch.distributed process group (multihost.initialize, "
                           "or spawn_ranks)")
    world = dist.get_world_size()
    if n_data < 1 or n_space < 1 or n_data * n_space != world:
        raise ValueError(f"need {n_data * n_space} ranks for a ({n_data},{n_space}) dp x sp mesh; the process "
                         f"group has {world}")
    mesh = data_mesh(world, device=device, hosts=1)
    backend = dist.get_backend()
    data_groups = [dist.new_group([d * n_space + s for d in range(n_data)], backend=backend) for s in range(n_space)]
    space_groups = [dist.new_group([d * n_space + s for s in range(n_space)], backend=backend)
                    for d in range(n_data)]
    rank = mesh.rank
    return DataMesh(rank, world, mesh.device, hosts=hosts, space=n_space, data_group=data_groups[rank % n_space],
                    space_group=space_groups[rank // n_space])


def local_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:<LOCAL_RANK>`` (torchrun's, or
    ``spawn_ranks``'s), or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    index = int(os.environ.get("LOCAL_RANK", "0"))
    if not torch.cuda.is_available() or index >= torch.cuda.device_count():
        raise RuntimeError(f"rank with LOCAL_RANK={index} finds {torch.cuda.device_count()} CUDA devices; a "
                           f"data-parallel run on the card needs one per rank")
    return torch.device("cuda", index)


def pad_batch_to_multiple(batch, n: int) -> Tuple[object, np.ndarray]:
    """``(padded, weights)``: ``batch`` (array or tensor) padded on dim 0 to a
    multiple of ``n`` by repeating its first element, and (B_padded,) f32
    0/1 validity weights. Evaluation only: the val steps run in eval mode
    and mask their reductions, so the padding drops out exactly. Train
    batches must divide the ranks instead (``Trainer`` raises): repeated
    samples would bias the losses and BatchNorm's batch statistics."""
    b = batch.shape[0]
    pad = (-b) % n
    w = np.zeros((b + pad,), np.float32)
    w[:b] = 1.0
    if pad == 0:
        return batch, w
    if isinstance(batch, torch.Tensor):
        return torch.cat([batch, batch[:1].expand(pad, *batch.shape[1:])]), w
    return np.concatenate([batch, np.repeat(batch[:1], pad, axis=0)]), w


def free_port() -> int:
    """A TCP port on localhost that no socket holds right now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(rank: int, fn: Callable, world_size: int, port: int, backend: str, args: tuple,
                timeout: Optional[float] = None):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world_size), GROUP_RANK="0",
                      GROUP_WORLD_SIZE="1")
    kw = {} if timeout is None else {"timeout": timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank, world_size=world_size, **kw)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, args: tuple = (), backend: str = "nccl",
                timeout: Optional[float] = None) -> None:
    """Run ``fn(*args)`` in ``world_size`` new processes (``spawn``), each a
    rank of one process group on this host (``tcp://localhost`` on a free
    port), with torchrun's environment variables set; returns when all have
    finished, and raises if one failed. ``fn`` must be importable by name
    (a module-level function). ``timeout``: seconds a collective may wait
    before it fails (None: the backend's default)."""
    mp.start_processes(_rank_entry, args=(fn, world_size, free_port(), backend, args, timeout), nprocs=world_size,
                       start_method="spawn", join=True)
