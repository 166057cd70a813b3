"""The pod drill (the counterpart of ``tests/test_multihost.py``'s
``test_pod_drill_preempt_one_of_four_then_elastic_resume`` and
``tests/multihost_drill_worker.py``): four host processes, each one host
of one rank (torchrun's environment, ``GROUP_RANK`` of
``GROUP_WORLD_SIZE`` 4), in a gloo group on the CPU, train through
``Trainer.fit`` with ``install_preemption_handler`` on one fold of one HDF5
corpus file per label (4 members each), which ``host_fold_shard`` deals
over the hosts: each host reads one member of each file. Tiny widths, as
JAX's drill worker (generator 1 / 1 / 2, critic 2 / depth 1, 16^3
patches).

Host 2 sends itself a real SIGTERM while its loader draws iteration 3's
batch. The stop flags are all-reduced every 5 iterations (the port's
``stop_sync_every`` here), so all four hosts stop at iteration 5: one
``5.pt`` from rank 0 and one data sidecar per host. Then this process
resumes the run on one process: it restores iteration 5, warns that the
sidecars were written by another host count, starts fresh data streams
and trains to iteration 9, writing ``9.pt`` and the one-host
``9.data.pkl``. The spawn has a deadline: a host that hangs in a
collective fails the test instead of the suite.
"""

import logging
import os
import signal
import time
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from contrast_gan_3d_tpu_torch.data import hdf5
from contrast_gan_3d_tpu_torch.data.labeling import divide_scans_in_fold
from contrast_gan_3d_tpu_torch.data.pipeline import create_loaders
from contrast_gan_3d_tpu_torch.models.discriminator import PatchGANDiscriminator
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.parallel import multihost
from contrast_gan_3d_tpu_torch.parallel.mesh import data_mesh, free_port
from contrast_gan_3d_tpu_torch.trainer import checkpoint as ckpt_lib
from contrast_gan_3d_tpu_torch.trainer.optim import make_optimizer
from contrast_gan_3d_tpu_torch.trainer.steps import StepConfig
from contrast_gan_3d_tpu_torch.trainer.trainer import OPT, Trainer, TrainerConfig, install_preemption_handler
from tests.synth import synthetic_patient

HOSTS = 4
MEMBERS = 4  # per label's corpus file: one a host
PATCH = (16, 16, 16)
GEN = dict(n_resnet_blocks=1, n_updownsample_blocks=1, init_channels_out=2)
CRITIC = dict(init_channels_out=2, discriminator_depth=1)
BATCH = {0: 2, -1: 1, 1: 1}  # a host's batches, as JAX's drill worker loads them
SIGNAL_HOST, SIGNAL_AT = 2, 3
SYNC, HORIZON, RESUMED = 5, 40, 9
DEADLINE_S = 300


def _trainer(ckpt_dir, iterations, mesh=None):
    torch.manual_seed(0)
    tx = partial(make_optimizer, "adam", lr=1e-3)
    return Trainer(ResnetGenerator(**GEN), PatchGANDiscriminator(**CRITIC), tx, tx, StepConfig(), TrainerConfig(
        train_iterations=iterations, train_critic_every=1, train_generator_every=2, val_every=None, log_every=1,
        log_images_every=None, checkpoint_every=10**6, checkpoint_dir=str(ckpt_dir), stop_sync_every=SYNC),
        device="cpu", mesh=mesh)


class _SignalAt:
    """A loader that sends its process SIGTERM when iteration ``at``'s
    batch is drawn (once: a second signal would escalate), forwarding the
    rest (``start``, ``stop``, the stream state) to ``loader``."""

    def __init__(self, loader, at):
        self.loader, self.at, self.n = loader, at, 0

    def __next__(self):
        if self.n == self.at:
            os.kill(os.getpid(), signal.SIGTERM)
        self.n += 1
        return next(self.loader)

    def __getattr__(self, name):
        return getattr(self.loader, name)


def _host_entry(host, port, tmp, fold):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(host), WORLD_SIZE=str(HOSTS),
                      LOCAL_RANK="0", LOCAL_WORLD_SIZE="1", GROUP_RANK=str(host), GROUP_WORLD_SIZE=str(HOSTS))
    torch.set_num_threads(1)
    multihost.initialize("gloo")
    mesh = data_mesh(device="cpu", hosts=multihost.host_topology()[1])
    shard = multihost.host_fold_shard(fold)
    loaders = create_loaders(shard, PATCH, BATCH, np.random.default_rng(170 + host), num_threads=1, prefetch=1,
                             to_device=False)
    if host == SIGNAL_HOST:
        loaders[OPT] = _SignalAt(loaders[OPT], SIGNAL_AT)
    trainer = _trainer(Path(tmp) / "ckpt", HORIZON, mesh)
    install_preemption_handler(trainer)
    trainer.fit(loaders)
    out = dict(iteration=trainer.iteration, stop_requested=trainer.stop_requested, host_index=mesh.host_index,
               shard=shard)
    torch.save(out, Path(tmp) / f"host{host}.pt")
    torch.distributed.destroy_process_group()


def _corpus_fold(root):
    """One corpus file per label, ``MEMBERS`` patients each; the fold
    names the files."""
    rng = np.random.default_rng(0)
    fold = []
    for label, name in ((0, "opt.h5"), (-1, "low.h5"), (1, "high.h5")):
        for i in range(MEMBERS):
            vol, mask, _, meta = synthetic_patient(rng, shape=(20, 20, 20))
            hdf5.write_patient_h5(vol, mask, meta, f"p{i}", root / name)
        fold.append((str(root / name), label))
    return fold


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pod")
    fold = _corpus_fold(tmp)
    ctx = mp.start_processes(_host_entry, args=(free_port(), str(tmp), fold), nprocs=HOSTS, start_method="spawn",
                             join=False)
    deadline = time.monotonic() + DEADLINE_S
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {HOSTS} hosts did not finish within {DEADLINE_S} s")
    return dict(tmp=tmp, fold=fold, out=[torch.load(tmp / f"host{h}.pt") for h in range(HOSTS)])


def test_every_host_reads_its_own_corpus_members(drill):
    """``host_fold_shard`` deals each corpus file's members over the
    hosts: one member of each label a host, disjoint, covering the fold."""
    members = divide_scans_in_fold(drill["fold"])
    for h, out in enumerate(drill["out"]):
        assert out["host_index"] == h
        assert out["shard"] == [(ps[h], label) for label, ps in members.items()]
    assert sorted(p for out in drill["out"] for p, _ in out["shard"]) == sorted(p for ps in members.values()
                                                                               for p in ps)


def test_one_hosts_sigterm_stops_all_four_at_the_same_iteration(drill):
    """Host 2 is signalled at iteration 3; the flags are all-reduced every
    5 iterations, so all four stop at 5, each with its stop flag set."""
    assert [(out["iteration"], out["stop_requested"]) for out in drill["out"]] == [(SYNC, True)] * HOSTS
    ckpt = drill["tmp"] / "ckpt"
    assert sorted(p.name for p in ckpt.glob("*.pt")) == [f"{SYNC}.pt"]
    assert sorted(p.name for p in ckpt.glob("*.data*.pkl")) == [f"{SYNC}.data.host{h}.pkl" for h in range(HOSTS)]


def test_resume_on_one_process_restores_and_trains_to_the_new_horizon(drill, caplog):
    """The pod's checkpoint on one process: iteration 5 restored with the
    pod's weights, the four-host sidecars refused with a warning (fresh
    streams over the whole fold), then iterations 5 to 9 and the one-host
    checkpoint and sidecar."""
    ckpt = drill["tmp"] / "ckpt"
    saved = torch.load(ckpt / f"{SYNC}.pt", weights_only=False)
    trainer = _trainer(ckpt, RESUMED)
    assert trainer.iteration == SYNC
    for k, v in trainer.state.generator.state_dict().items():
        assert torch.equal(v, saved["generator"][k]), k
    loaders = create_loaders(drill["fold"], PATCH, BATCH, np.random.default_rng(199), num_threads=1, prefetch=1,
                             to_device=False)
    with caplog.at_level(logging.WARNING, logger="contrast_gan_3d_tpu_torch.trainer.checkpoint"):
        trainer.fit(loaders)
    assert any("another host count" in r.getMessage() for r in caplog.records)
    assert trainer.iteration == RESUMED and not trainer.stop_requested
    assert sorted(p.name for p in ckpt.glob("*.pt")) == [f"{SYNC}.pt", f"{RESUMED}.pt"]
    assert (ckpt / f"{RESUMED}.data.pkl").exists()
    assert ckpt_lib.find_latest_checkpoint(ckpt).name == f"{RESUMED}.pt"
