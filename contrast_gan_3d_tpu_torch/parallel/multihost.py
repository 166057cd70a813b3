"""Multi-host runs (counterpart of ``contrast_gan_3d_tpu/parallel/multihost.py``).

A JAX process is a host and drives that host's devices; a torch rank
drives one device. So here a host is torchrun's node (``GROUP_RANK`` of
``GROUP_WORLD_SIZE``), and the ranks of a host (``LOCAL_WORLD_SIZE``)
split each of its batches:

    torchrun --nnodes 2 --node-rank <i> --nproc-per-node 8 \\
        --rdzv-endpoint <host 0>:29500 -m contrast_gan_3d_tpu_torch.train --multihost ...

- :func:`initialize` joins the process group from torchrun's environment
  (NCCL with a card, gloo without);
- :func:`host_fold_shard` gives each host a disjoint round-robin share of
  every label's patients, HDF5 corpus files expanded to their members
  first (the sharded HDF5 corpus: each host reads only its members);
- :func:`host_local_batch_slice` is the slice of a global batch a host
  loads.

The rank's device and its share of a host batch are ``parallel/mesh.py``'s.
"""

import logging
import os
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from contrast_gan_3d_tpu_torch.data.hdf5 import shard_members
from contrast_gan_3d_tpu_torch.data.labeling import divide_scans_in_fold

logger = logging.getLogger(__name__)


def host_topology() -> Tuple[int, int]:
    """(host index, host count) from torchrun's ``GROUP_RANK`` /
    ``GROUP_WORLD_SIZE`` (one host without them)."""
    return int(os.environ.get("GROUP_RANK", "0")), int(os.environ.get("GROUP_WORLD_SIZE", "1"))


def initialize(backend: Optional[str] = None) -> None:
    """Join this process into the process group torchrun describes
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); ``backend``
    defaults to NCCL when a card is visible, else gloo. A group already
    joined is kept."""
    if dist.is_initialized():
        return
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError(f"multihost.initialize: {', '.join(missing)} not set; launch with torchrun (or give "
                           f"the process group its address, world size and rank)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend)
    host, hosts = host_topology()
    logger.info("distributed initialized: rank %d/%d, host %d/%d, backend %s", dist.get_rank(),
                dist.get_world_size(), host, hosts, backend)


def host_local_batch_slice(global_batch: int, host_index: Optional[int] = None,
                           host_count: Optional[int] = None) -> slice:
    """The slice of a globally indexed batch this host loads: batches shard
    over their leading axis in host order (the ranks of host ``h`` hold
    global samples ``[h * B / H, (h + 1) * B / H)``)."""
    h, n = host_topology()
    h = h if host_index is None else host_index
    n = n if host_count is None else host_count
    if global_batch % n:
        raise ValueError(f"a global batch of {global_batch} does not split over {n} hosts")
    per = global_batch // n
    return slice(h * per, (h + 1) * per)


def host_fold_shard(fold, host_index: Optional[int] = None, host_count: Optional[int] = None) -> List:
    """This host's share of a fold's (path, label) entries: every label's
    patients (an HDF5 corpus file's members, ``divide_scans_in_fold``)
    dealt round-robin over the hosts (``paths[h::H]``,
    ``data/hdf5.shard_members``), so the hosts sample disjoint patients
    with balanced label mixes and none opens another's members. Every host
    needs every label's stream: a label with fewer patients than hosts
    raises."""
    h, n = host_topology()
    h = h if host_index is None else host_index
    n = n if host_count is None else host_count
    shard = []
    for label, paths in divide_scans_in_fold(fold).items():
        mine = shard_members(paths, h, n)
        if not mine:
            raise ValueError(f"label {label} has {len(paths)} patients, too few for {n} hosts (host {h} would have "
                             f"an empty stream)")
        shard.extend((p, label) for p in mine)
    return shard
