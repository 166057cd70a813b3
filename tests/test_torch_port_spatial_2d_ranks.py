"""The rank side of ``tests/test_torch_port_spatial_2d.py``: what each gloo
process of a 2D dp x sp mesh runs. It imports no JAX, so that a spawned
rank starts quickly; the test module builds the payload (JAX's weights
and the slices as state dicts and arrays) and holds the ranks' results to
the JAX package and to the port's one-rank steps. No tests here."""

import numpy as np
import torch

from contrast_gan_3d_tpu_torch.data.augment import Augment2DConfig
from contrast_gan_3d_tpu_torch.parallel.mesh import LOCAL, dp_sp_mesh
from contrast_gan_3d_tpu_torch.trainer.steps import StepConfig, build_preview_step, build_train_steps
from tests.test_torch_port_spatial_ranks import _data_share, _result, one_step, port_state, val

# the meshes each world size runs, (data, space)
MESHES = {2: ((1, 2),), 4: ((2, 2), (1, 4))}
# the case whose step augments its slices on the device, and the one the
# val steps and the preview run on
AUGMENT, VAL = ("augment",), ("wc", "same")


def augment_step(case, batch, mesh=LOCAL):
    """One weight-clip ``combined_step`` that rotates and mirrors every
    slice on the device (``Augment2DConfig``, every gate open) before the
    slab is kept, then the preview of that step's augmented sub-optimal
    batch re-derived from the rng state before it: (metrics, generator
    state, critic state, gradients, (scaled batch, corrected batch,
    attenuation, mask) of the preview, whole)."""
    cfg = StepConfig(weight_clip=case["weight_clip"], augment=Augment2DConfig(p_rotation=1.0, p_mirror=1.0))
    state = port_state(case, mesh)
    share = _data_share(batch, mesh)
    rng_before = state.rng.get_state()
    state, metrics = build_train_steps(cfg).combined_step(state, *share)
    preview = build_preview_step(cfg)(state, rng_before, share[1], share[2])
    return ({k: float(v) for k, v in metrics.items()}, *_result(state), tuple(t.detach() for t in preview))


def sp_2d_worker(payload_path, out_dir):
    torch.set_num_threads(1)
    payload = torch.load(payload_path, weights_only=False)
    world = torch.distributed.get_world_size()
    result = {}
    for shape in MESHES[world]:
        mesh = dp_sp_mesh(*shape, device="cpu")
        res = result[shape] = {"rank": mesh.rank, "steps": {}}
        for key, case in payload["cases"].items():
            batch = payload["batches"][key]
            run = augment_step if key == AUGMENT else one_step
            res["steps"][key] = run(case, batch, mesh)
        res["val"] = val(payload["cases"][VAL], payload["val_batch"], mesh)
        res["val_512"] = val(payload["cases"][VAL], payload["val_batch_512"], mesh)
    torch.save(result, f"{out_dir}/rank{torch.distributed.get_rank()}.pt")


def slices(rng, patch, b=4):
    """(OPT, sub-optimal, centerline mask) int16 slices, ``b`` of each."""
    opt = rng.integers(-500, 500, (b, *patch)).astype(np.int16)
    sub = rng.integers(-500, 500, (b, *patch)).astype(np.int16)
    msk = (rng.random((b, *patch)) < 0.05).astype(np.int16)
    return opt, sub, msk
