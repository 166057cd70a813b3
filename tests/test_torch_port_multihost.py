"""Multi-host runs of the port (``contrast_gan_3d_tpu_torch/parallel/
multihost.py``), the counterparts of the JAX package's
``tests/test_multihost.py``: two processes, each one host of one rank
(torchrun's environment: ``GROUP_RANK`` of ``GROUP_WORLD_SIZE`` 2), in a
gloo group on the CPU, all three checks in one spawn:
- one data-parallel step through ``multihost.initialize`` and
  ``host_local_batch_slice`` on each host's share of the global batch
  equals the one-process step on the global batch (JAX's DP tolerance:
  metrics rtol 2e-4 / atol 1e-5, parameters rtol 2e-3 / atol 2e-5);
- the coordinated graceful stop: a SIGTERM to one host's process stops
  both at the same iteration, the next stop sync;
- the train CLI with ``--multihost`` on a two-host fold shard: each host
  samples its own patients, writes its own data sidecar, and rank 0 the
  checkpoint.
Then ``train --dp-devices 2 --device cpu`` (two ranks the command starts
itself) against the same command without it: the same batches, so the
same networks up to the order of the sums (Adam's first steps are about
lr * sign(g), so every parameter within 2 lr per update, 99% within 1e-5).
"""

import os
import pickle
import signal
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from contrast_gan_3d_tpu_torch import train as train_cli
from contrast_gan_3d_tpu_torch.data.preprocess import write_patient
from contrast_gan_3d_tpu_torch.models.discriminator import PatchGANDiscriminator
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.parallel import multihost
from contrast_gan_3d_tpu_torch.parallel.mesh import data_mesh, free_port
from contrast_gan_3d_tpu_torch.trainer import checkpoint as ckpt_lib
from contrast_gan_3d_tpu_torch.trainer.optim import make_optimizer
from contrast_gan_3d_tpu_torch.trainer.steps import StepConfig, build_train_steps, init_state
from contrast_gan_3d_tpu_torch.trainer.trainer import HIGH, LOW, OPT, Trainer, TrainerConfig, \
    install_preemption_handler

HOSTS = 2
PATCH = (16, 16, 16)
GEN = dict(n_resnet_blocks=1, n_updownsample_blocks=1, init_channels_out=2)
CRITIC = dict(init_channels_out=2, discriminator_depth=1)
STOP_AT = 3  # rank 1 signals itself while loading this iteration's batches
OVERRIDE = '''
from dataclasses import replace


def config(base):
    return replace(base, name="tiny", train_patch_size=(16, 16, 16), val_patch_size=(16, 16, 16),
                   train_batch_size={0: 2, -1: 2, 1: 2}, val_batch_size={0: 2, -1: 2, 1: 2},
                   generator_args={"n_resnet_blocks": 1, "n_updownsample_blocks": 1, "init_channels_out": 4},
                   critic_args={"init_channels_out": 4, "discriminator_depth": 2, "negative_slope": 0.2},
                   compute_dtype="float32", augment_backend="device", num_workers=(1, 1), log_every=2,
                   validate_every=2, val_iterations=1, checkpoint_every=2, logger="file")
'''


def _nets(seed=0):
    torch.manual_seed(seed)
    return ResnetGenerator(**GEN), PatchGANDiscriminator(**CRITIC)


def _step(batch, mesh=None):
    gen, critic = _nets()
    tx = partial(make_optimizer, "adam", lr=1e-3)
    state = init_state(gen, critic, tx, tx, seed=0, device="cpu", mesh=mesh)
    state, m = build_train_steps(StepConfig(weight_clip=None)).combined_step(state, *batch)
    return {k: float(v) for k, v in m.items()}, {k: v.clone() for k, v in state.generator.state_dict().items()}


class _Stream:
    """An endless loader of one fixed batch; rank 1's OPT stream sends its
    process SIGTERM when the batch of iteration ``STOP_AT`` is drawn (once:
    a second signal would escalate)."""

    def __init__(self, batch, signal_at=None):
        self.batch, self.signal_at, self.n = batch, signal_at, 0

    def __next__(self):
        if self.n == self.signal_at:
            os.kill(os.getpid(), signal.SIGTERM)
        self.n += 1
        return self.batch


def _graceful_stop(mesh, ckpt_dir):
    gen, critic = _nets(1)
    tx = partial(make_optimizer, "adam", lr=1e-3)
    trainer = Trainer(gen, critic, tx, tx, StepConfig(), TrainerConfig(
        train_iterations=40, train_generator_every=2, val_every=None, log_every=None, log_images_every=None,
        checkpoint_every=100, checkpoint_dir=str(ckpt_dir), stop_sync_every=5), device="cpu", mesh=mesh)
    install_preemption_handler(trainer)
    b = {"data": np.zeros((1, *PATCH), np.int16), "seg": np.zeros((1, *PATCH), np.int16)}
    at = STOP_AT if mesh.rank == 1 else None
    trainer.fit({OPT: _Stream(b, at), LOW: _Stream(b), HIGH: _Stream(b)})
    return trainer.iteration, trainer.stop_requested


def _host_entry(host, port, tmp):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(host), WORLD_SIZE=str(HOSTS),
                      LOCAL_RANK="0", LOCAL_WORLD_SIZE="1", GROUP_RANK=str(host), GROUP_WORLD_SIZE=str(HOSTS))
    torch.set_num_threads(1)
    multihost.initialize("gloo")
    mesh = data_mesh(device="cpu", hosts=multihost.host_topology()[1])
    out = {"rank": mesh.rank, "hosts": mesh.hosts, "host_index": mesh.host_index}
    blob = np.load(Path(tmp) / "batch.npz")
    sl = multihost.host_local_batch_slice(len(blob["opt"]))
    out["step"] = _step(tuple(blob[k][sl] for k in ("opt", "sub", "msk")), mesh)
    out["stop"] = _graceful_stop(mesh, Path(tmp) / "stop")
    manager = train_cli.main([*pickle.loads((Path(tmp) / "argv.pkl").read_bytes()), "--multihost"])
    run = manager.runs[0]
    out["fold"] = sorted(str(p) for loader in run.train_loaders.values() for p in loader.sampler.paths)
    out["cli_iteration"] = run.trainer.iteration
    out["cli_batch"] = run.train_loaders[OPT].sampler.batch_size
    torch.save(out, Path(tmp) / f"host{host}.pt")
    torch.distributed.destroy_process_group()


def _patients(root, n_per_label=2, shape=(24, 24, 24)):
    rng = np.random.default_rng(0)
    fold = []
    for label in (0, -1, 1):
        for i in range(n_per_label):
            vol = rng.normal(40.0 + 150 * label, 30.0, shape).astype(np.int16)
            mask = np.zeros(shape, np.uint8)
            mask[4:20, 12, 12] = 1
            meta = {"spacing": np.array([0.5, 0.5, 0.5]), "offset": np.zeros(3),
                    "centerlines_world": np.zeros((0, 4), np.float32)}
            fold.append((str(write_patient(vol, mask, meta, f"p_{label}_{i}", root)), label))
    return fold


def _cli_args(tmp, fold, run_id):
    conf, splits = tmp / "tiny.py", tmp / "splits.pkl"
    conf.write_text(OVERRIDE)
    splits.write_bytes(pickle.dumps({"train": [fold], "test": [fold]}))
    return ["--conf", str(conf), "--cval-splits", str(splits), "--checkpoint-root", str(tmp / "runs"),
            "--run-id", run_id, "--device", "cpu", "--iterations", "4"]


@pytest.fixture(scope="module")
def hosts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    rng = np.random.default_rng(3)
    batch = dict(opt=rng.integers(-1024, 1500, (4, *PATCH)).astype(np.int16),
                 sub=rng.integers(-1024, 1500, (4, *PATCH)).astype(np.int16),
                 msk=(rng.random((4, *PATCH)) < 0.05).astype(np.int16))
    np.savez(tmp / "batch.npz", **batch)
    fold = _patients(tmp / "patients")
    (tmp / "argv.pkl").write_bytes(pickle.dumps(_cli_args(tmp, fold, "mh")))
    mp.start_processes(_host_entry, args=(free_port(), str(tmp)), nprocs=HOSTS, start_method="spawn", join=True)
    return dict(tmp=tmp, batch=batch, fold=fold, out=[torch.load(tmp / f"host{h}.pt") for h in range(HOSTS)])


def test_two_hosts_run_one_data_parallel_step(hosts):
    want_m, want_g = _step(tuple(hosts["batch"][k] for k in ("opt", "sub", "msk")))
    for h, out in enumerate(hosts["out"]):
        assert (out["rank"], out["hosts"], out["host_index"]) == (h, HOSTS, h)
        got_m, got_g = out["step"]
        for k in want_m:
            np.testing.assert_allclose(got_m[k], want_m[k], rtol=2e-4, atol=1e-5, err_msg=k)
        for k in want_g:
            np.testing.assert_allclose(got_g[k].numpy(), want_g[k].numpy(), rtol=2e-3, atol=2e-5, err_msg=k)


def test_one_hosts_sigterm_stops_every_host_at_the_same_iteration(hosts):
    """Rank 1 is signalled at iteration 3; the flags are all-reduced every 5
    iterations, so both stop at 5 and rank 0 writes the checkpoint there."""
    stops = [out["stop"] for out in hosts["out"]]
    assert stops == [(5, True), (5, True)]
    assert ckpt_lib.find_latest_checkpoint(hosts["tmp"] / "stop").name == "5.pt"


def test_train_cli_multihost_shards_the_fold(hosts):
    folds = [set(out["fold"]) for out in hosts["out"]]
    assert not folds[0] & folds[1] and folds[0] | folds[1] == {p for p, _ in hosts["fold"]}
    for out in hosts["out"]:
        assert out["cli_iteration"] == 4 and out["cli_batch"] == 1  # the global 2 over 2 hosts
    run = hosts["tmp"] / "runs" / "mh"
    assert ckpt_lib.find_latest_checkpoint(run).name == "4.pt"
    assert {p.name for p in run.glob("4.data*.pkl")} == {"4.data.host0.pkl", "4.data.host1.pkl"}
    assert multihost.host_fold_shard(hosts["fold"], 1, 2) == [
        (p, label) for p, label in hosts["fold"] if p in folds[1]]


def test_host_fold_shard_refuses_an_empty_stream():
    with pytest.raises(ValueError, match="too few for 3 hosts"):
        multihost.host_fold_shard([("a", 0), ("b", 0), ("c", 0), ("d", -1)], 1, 3)
    assert multihost.host_local_batch_slice(6, 1, 3) == slice(2, 4)
    with pytest.raises(ValueError, match="does not split over 4 hosts"):
        multihost.host_local_batch_slice(6, 0, 4)


def test_train_dp_devices_trains_on_the_one_rank_batches(tmp_path, monkeypatch):
    """``--dp-devices 2`` on the CPU: the command starts two gloo ranks,
    which load the batches the one-process run loads and split them (one
    intra-op thread each: the suite runs beside them)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    fold = _patients(tmp_path / "patients")
    one = train_cli.main(_cli_args(tmp_path, fold, "one"))
    assert train_cli.main(_cli_args(tmp_path, fold, "two") + ["--dp-devices", "2"]) is None
    want = one.runs[0].trainer.state
    got = torch.load(ckpt_lib.find_latest_checkpoint(tmp_path / "runs" / "two"), weights_only=False)
    assert got["step"] == want.step == 4
    for module, key, lr in ((want.generator, "generator", 2e-4), (want.critic, "critic", 2e-4)):
        for k, v in module.state_dict().items():
            diff = (got[key][k].float() - v.float()).abs()
            if k.endswith(("running_mean", "running_var")):
                assert diff.max() <= 1e-4, k
            else:
                assert diff.max() <= 2 * lr * 4 + 1e-5 and (diff <= 1e-5).float().mean() >= 0.99, k
