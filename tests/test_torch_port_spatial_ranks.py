"""The rank side of ``tests/test_torch_port_spatial.py``: what each gloo
process of a dp x sp mesh runs. It imports no JAX, so that a spawned rank
starts quickly; the test module builds the payload (JAX's weights and the
batches as state dicts and arrays) and holds the ranks' results to the
JAX package and to the port's one-rank step. No tests here."""

import copy
from functools import partial

import numpy as np
import torch
from torch.autograd import gradcheck, gradgradcheck

from contrast_gan_3d_tpu_torch.models.discriminator import PatchGANDiscriminator
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.ops.packed import packed_conv3d, packed_conv3d_padded, packed_tconv3d, reflect_pad_packed
from contrast_gan_3d_tpu_torch.parallel.mesh import LOCAL, dp_sp_mesh, pad_batch_to_multiple
from contrast_gan_3d_tpu_torch.parallel.spatial import bounds, conv_window, halo_extend, tconv_window
from contrast_gan_3d_tpu_torch.trainer import optim
from contrast_gan_3d_tpu_torch.trainer.steps import (
    StepConfig,
    build_cycle_step,
    build_train_steps,
    build_val_steps,
    init_state,
)

# the meshes each world size runs, (data, space)
MESHES = {2: ((1, 2),), 4: ((2, 2), (1, 4))}
CYCLE_MESH = (2, 2)


def port_nets(case):
    gen = ResnetGenerator(**case["gen_kw"])
    gen.load_state_dict(case["gen"], strict=True)
    critic = PatchGANDiscriminator(**case["critic_kw"])
    critic.load_state_dict(case["critic"], strict=True)
    return gen, critic


def port_state(case, mesh):
    gen, critic = port_nets(case)
    tx = partial(optim.make_optimizer, "adam", lr=case["lr"], betas=case["betas"])
    return init_state(gen, critic, tx, tx, seed=case["seed"], device="cpu", mesh=mesh)


def _cfg(case) -> StepConfig:
    return StepConfig(weight_clip=case["weight_clip"], gp_eps=case["gp_eps"])


def _data_share(batch, mesh):
    return tuple(b[mesh.global_slice(len(b) // mesh.data_size)] for b in batch)


def _result(state):
    grads = {f"{net}.{k}": p.grad.clone() for net in ("generator", "critic")
             for k, p in getattr(state, net).named_parameters()}
    return (copy.deepcopy(state.generator.state_dict()), copy.deepcopy(state.critic.state_dict()), grads)


def one_step(case, batch, mesh=LOCAL):
    """One ``combined_step`` of ``case`` on this rank's share of ``batch``:
    (metrics, generator state, critic state, gradients by name)."""
    state = port_state(case, mesh)
    state, metrics = build_train_steps(_cfg(case)).combined_step(state, *_data_share(batch, mesh))
    return ({k: float(v) for k, v in metrics.items()}, *_result(state))


def cycle(case, batches, pattern, mesh=LOCAL):
    """One eager cycle of ``pattern`` on (K, B, ...) stacked batches."""
    state = port_state(case, mesh)
    step = build_cycle_step(build_train_steps(_cfg(case)), pattern)
    stacked = tuple(torch.from_numpy(b[:, mesh.global_slice(b.shape[1] // mesh.data_size)]) for b in batches)
    state, metrics = step(state, *stacked)
    return ({k: float(v) for k, v in metrics.items()}, *_result(state)[:2], dict(step.calls))


def val(case, batch, mesh=LOCAL):
    """The val steps on ``batch`` padded to the data ranks: (critic score
    on it, realism and ZNCC of its correction, this rank's corrected
    batch, whole)."""
    state = port_state(case, mesh)
    vo, vs = build_val_steps(StepConfig())
    padded, w = pad_batch_to_multiple(batch, mesh.data_size)
    keep = mesh.global_slice(len(padded) // mesh.data_size)
    data, w = torch.from_numpy(padded[keep]), torch.from_numpy(w[keep])
    realism, zncc, sample_hat, _ = vs(state, data, w)
    return float(vo(state, data, w)), float(realism), float(zncc), sample_hat


def _halo_fn(mesh, n, windows, mode):
    """A function of the whole tensor that every rank computes alike, so
    that ``gradcheck``'s lockstep perturbations test the exchange: each
    rank's extended slab of it, placed at the rank's offset and summed over
    the ranks (the all-reduce of the input makes its gradient whole)."""
    lengths = [hi - lo for lo, hi in windows]
    offset = sum(lengths[: mesh.space_index])

    def fn(x):
        whole = mesh.all_sum(x) / mesh.world_size
        lo, hi = mesh.slab(n)
        ext = halo_extend(whole.narrow(2, lo, hi - lo), mesh, n, windows, mode)
        out = torch.nn.functional.pad(ext, (0, 0, 0, 0, offset, sum(lengths) - offset - ext.shape[2]))
        return mesh.all_sum(out)

    return fn


def halo_checks(mesh):
    """float64 ``gradcheck`` and ``gradgradcheck`` of the exchange on a
    reflect-padded 7^3 window and a zero-padded transpose-conv window."""
    out = {}
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(1, 2, 8, 2, 1))).requires_grad_(True)
    for name, n, window, mode in (
        ("reflect 7", 8, lambda o0, o1: conv_window(o0, o1, 7, 1, 3), "reflect"),
        ("zeros k4 s2", 8, lambda o0, o1: conv_window(o0, o1, 4, 2, 1), "zeros"),
        ("tconv torch", 8, lambda o0, o1: tconv_window(o0, o1, 3, 2, 1), "zeros"),
    ):
        n_out = {"reflect 7": n, "zeros k4 s2": n // 2, "tconv torch": 2 * n}[name]
        windows = tuple(window(*bounds(n_out, mesh.space, q)) for q in range(mesh.space))
        fn = _halo_fn(mesh, n, windows, mode)
        out[name] = (gradcheck(fn, (x,), raise_exception=False), gradgradcheck(fn, (x,), raise_exception=False))
    return out


def packed_checks(mesh):
    """The packed layout's convs on slabs (``ops/packed.packed_conv3d_padded``
    / ``packed_tconv3d`` under the mesh) in float64 at two ranks: (each rank's output
    equals its slab of the conv of the whole tensor, ``gradcheck``,
    ``gradgradcheck``) of the stem's reflect-padded 7^3 f2 -> f2 conv, the
    projection's f2 -> f4, a stride-2 downsample f2 -> f2 and the
    torch-placed transpose conv. The gradchecks perturb the whole tensor
    on every rank in lockstep (``_halo_fn``'s construction)."""
    rng = np.random.default_rng(11)
    f = lambda *shape: torch.from_numpy(rng.normal(size=shape))
    x = f(1, 8, 3, 3, 8)  # 8 block rows: two slabs of 4
    cases = {
        "packed stem reflect": (x, f(7, 7, 7, 1, 1), dict(f_in=2, f_out=2, pad=3, mode="reflect")),
        "packed projection reflect": (f(1, 8, 4, 4, 8), f(7, 7, 7, 1, 1), dict(f_in=2, f_out=4, pad=3,
                                                                               mode="reflect")),
        "packed down zeros": (f(1, 8, 2, 2, 8), f(3, 3, 3, 1, 2), dict(f_in=2, f_out=2, stride=2, pad=1)),
        "packed tconv torch": (f(1, 8, 2, 2, 2), f(3, 3, 3, 2, 1), None),
    }
    out = {}
    for name, (whole, w, kw) in cases.items():
        n = whole.shape[1]
        if kw is None:
            op = lambda v, m=mesh: packed_tconv3d(v, w, None, stride=2, convention="torch", mesh=m)
            want = packed_tconv3d(whole, w, None, stride=2, convention="torch")
        else:
            op = lambda v, m=mesh, kw=kw: packed_conv3d_padded(v, w, None, mesh=m, **kw)
            f_in, f_out, stride = kw["f_in"], kw["f_out"], kw.get("stride", 1)
            blocks = tuple(d * f_in // (stride * f_out) for d in whole.shape[1:4])
            # the whole tensor padded and convolved as packed_conv3d takes it
            if kw.get("mode") == "reflect":
                padded, o = reflect_pad_packed(whole, f_in, kw["pad"])
                want = packed_conv3d(padded, w, None, f_in=f_in, f_out=f_out, stride=stride, out_blocks=blocks,
                                     o=(o, o, o))
            else:
                want = packed_conv3d(whole, w, None, f_in=f_in, f_out=f_out, stride=stride, pad=kw["pad"],
                                     out_blocks=blocks)
        lo, hi = mesh.slab(n)
        got = op(whole.narrow(1, lo, hi - lo))
        n_out = want.shape[1]
        o0, o1 = bounds(n_out, mesh.space, mesh.space_index)
        same = bool(torch.allclose(got, want[:, o0:o1], rtol=1e-10, atol=1e-10))
        offsets = [bounds(n_out, mesh.space, q)[0] for q in range(mesh.space)]

        def fn(v, op=op, n_out=n_out, offset=offsets[mesh.space_index]):
            v = mesh.all_sum(v) / mesh.world_size
            y = op(v.narrow(1, lo, hi - lo))
            return mesh.all_sum(torch.nn.functional.pad(y, (0, 0, 0, 0, 0, 0, offset, n_out - offset - y.shape[1])))

        v = whole.clone().requires_grad_(True)
        out[name] = (same, gradcheck(fn, (v,), raise_exception=False, fast_mode=True),
                     gradgradcheck(fn, (v,), raise_exception=False, fast_mode=True))
    return out


def sp_worker(payload_path, out_dir):
    torch.set_num_threads(1)
    payload = torch.load(payload_path, weights_only=False)
    world = torch.distributed.get_world_size()
    result = {}
    for shape in MESHES[world]:
        mesh = dp_sp_mesh(*shape, device="cpu")
        res = result[shape] = {"rank": mesh.rank, "steps": {}}
        for key, case in payload["cases"].items():
            res["steps"][key] = one_step(case, payload["batch"], mesh)
        if shape == CYCLE_MESH:
            res["cycle"] = cycle(payload["cycle_case"], payload["cycle_batches"], payload["pattern"], mesh)
        res["val"] = val(payload["cases"]["wc", "same", "direct"], payload["val_batch"], mesh)
        res["val_packed"] = val(payload["cases"]["wc", "same", "packed"], payload["val_batch"], mesh)
        if world == 2:
            res["halo"] = {**halo_checks(mesh), **packed_checks(mesh)}
    torch.save(result, f"{out_dir}/rank{torch.distributed.get_rank()}.pt")
