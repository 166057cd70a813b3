"""The rank side of ``tests/test_torch_port_parallel.py``: what each of
its two gloo processes runs. It imports no JAX, so that a spawned rank
starts quickly; the test module builds the payload (JAX's weights, draws
and batches as state dicts and arrays) and holds the ranks' results to
the JAX package. No tests here."""

import copy
from functools import partial

import torch

from contrast_gan_3d_tpu_torch.data import augment as aug
from contrast_gan_3d_tpu_torch.models import losses
from contrast_gan_3d_tpu_torch.models.discriminator import PatchGANDiscriminator
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.models.norm import BatchNorm, set_mesh
from contrast_gan_3d_tpu_torch.parallel.mesh import data_mesh
from contrast_gan_3d_tpu_torch.trainer import optim
from contrast_gan_3d_tpu_torch.trainer.steps import StepConfig, build_train_steps, init_state
from contrast_gan_3d_tpu_torch.trainer.trainer import HIGH, LOW, OPT, Trainer

WORLD = 2


class FixedDraws:
    """``draw`` for ``build_train_steps``: the given global-batch draws, in
    the order a step asks for them (sub-optimal, then OPT)."""

    def __init__(self, draws):
        self.draws = list(draws)

    def __call__(self, generator, batch, cfg):
        d = self.draws.pop(0)
        assert d.angles.shape[0] == batch, (d.angles.shape, batch)
        return d


def _port_nets(case):
    gen = ResnetGenerator(**case["tiny"], layout=case["layout"])
    gen.load_state_dict(case["gen"], strict=True)
    critic = PatchGANDiscriminator(init_channels_out=4, discriminator_depth=2, norm=case["norm"])
    critic.load_state_dict(case["critic"], strict=True)
    return gen, critic


def _one_step(case, mesh, jax_draws: bool):
    """One ``combined_step`` of ``case`` (this rank's share under ``mesh``);
    returns (metrics, generator state, critic state, gradients): the
    gradients are the ones each optimizer stepped with (after the critic's
    and the generator's all-reduce), by parameter name."""
    gen, critic = _port_nets(case)
    tx = partial(optim.make_optimizer, "adam", lr=case["lr"], betas=case["betas"])
    cfg = StepConfig(weight_clip=case["weight_clip"], augment=aug.AugmentConfig(**case["augment"]),
                     gp_eps=case["gp_eps"] if jax_draws else None)
    state = init_state(gen, critic, tx, tx, seed=0, device="cpu", mesh=mesh)
    draw = FixedDraws(case["draws"]) if jax_draws else aug.draw
    opt, sub, msk = case["batch"]
    if mesh is not None:
        keep = mesh.batch_slice(len(sub))
        opt, sub, msk = opt[mesh.batch_slice(len(opt))], sub[keep], msk[keep]
    state, metrics = build_train_steps(cfg, draw=draw).combined_step(state, opt, sub, msk)
    grads = {f"{net}.{k}": p.grad.clone() for net in ("generator", "critic")
             for k, p in getattr(state, net).named_parameters()}
    return ({k: float(v) for k, v in metrics.items()}, copy.deepcopy(state.generator.state_dict()),
            copy.deepcopy(state.critic.state_dict()), grads)


def _ops_on_a_group(payload, mesh):
    """BatchNorm, the losses, the val steps and the errors on this rank."""
    out = {}
    sl = mesh.batch_slice(len(payload["bn_x"]))
    bn = BatchNorm(3)
    bn.load_state_dict(payload["bn_state"])
    set_mesh(bn, mesh)
    x = torch.from_numpy(payload["bn_x"][sl]).requires_grad_(True)
    y = bn(x)
    (y * torch.from_numpy(payload["bn_c"][sl])).sum().backward()
    out["bn"] = (y.detach(), x.grad, bn.running_mean.clone(), bn.running_var.clone())
    for name in ("zncc", "hu"):
        s = torch.from_numpy(payload["loss_s"][sl]).requires_grad_(True)
        if name == "zncc":
            value = losses.zncc_loss(s, torch.from_numpy(payload["loss_t"][sl]), mesh)
        else:
            value = losses.hu_loss(s, torch.from_numpy(payload["loss_m"][sl]), *payload["hu_bounds"], mesh)
        value.backward()
        out[name] = (float(value), s.grad)
    case = payload["cases"][("wc", "direct")]
    gen, critic = _port_nets(case)
    tx = partial(optim.make_optimizer, "adam", lr=1e-4)
    trainer = Trainer(gen, critic, tx, tx, StepConfig(), device="cpu", mesh=mesh)
    val = payload["val_batch"]
    data, w = trainer._put_val(val)
    sub = trainer.val_subopt_step(trainer.state, data, w)
    out["val"] = (float(trainer.val_opt_step(trainer.state, data, w)), float(sub[0]), float(sub[1]), w.tolist())
    odd = {OPT: {"data": val}, LOW: {"data": val[:2], "seg": val[:2]}, HIGH: {"data": val[:2], "seg": val[:2]}}
    try:
        trainer.train_step(odd, 0)
        out["divisibility"] = None
    except ValueError as e:
        out["divisibility"] = str(e)
    try:
        data_mesh(WORLD + 1, device="cpu")
        out["overrequest"] = None
    except ValueError as e:
        out["overrequest"] = str(e)
    return out


def _dp_worker(payload_path, out_dir):
    torch.set_num_threads(1)
    payload = torch.load(payload_path, weights_only=False)
    mesh = data_mesh(WORLD, device="cpu")
    result = {"rank": mesh.rank, "steps": {}, "port_steps": {}}
    for key, case in payload["cases"].items():
        result["steps"][key] = _one_step(case, mesh, jax_draws=True)
        result["port_steps"][key] = _one_step(case, mesh, jax_draws=False)
    result.update(_ops_on_a_group(payload, mesh))
    torch.save(result, f"{out_dir}/rank{mesh.rank}.pt")
