"""Plain reference of the WGAN training schedule (xqz-u/contrast-gan-3D,
``trainer/Trainer.py``), float32, on the networks of ``model.py``.

One iteration on raw int16 batches (OPT, sub-optimal, centerline mask):
scale both, run the generator once in train mode on the sub-optimal batch,
``opt_hat = sub - G(sub)``. When the critic is due it updates on
``mean(D(opt_hat)) - mean(D(opt))`` (each call normalising with its own
batch's statistics), takes an Adam step and clips every parameter into
``[-clip, clip]``. When the generator is due its loss is taken against the
updated critic: ``-mean(D(opt_hat))`` plus the negative zero-normalised
cross-correlation of ``opt_hat`` and ``sub`` (ddof=1 standard deviations)
plus the HU corridor (the squared distance of masked voxels from the
scaled corridor), then an Adam step on the generator alone.

Adam is written out (torch's update: bias-corrected moments, eps outside
the root). The critic is due every ``critic_every`` iterations and the
generator every ``generator_every``, iteration 0 included.
"""

from typing import Dict, List, Optional, Sequence

import torch

from benchmark.reference import model


class Adam:
    """Adam over a dict of float32 leaves, updated in place."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, betas: Sequence[float], eps: float = 1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, tuple(betas), eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]):
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1**self.t, 1 - b2**self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(self.lr / c1 * self.m[k] / (self.v[k].sqrt() / c2**0.5 + self.eps))


def zncc_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    cc = ((a - a.mean()) * (b - b.mean())).mean()
    return -(cc / (a.std() * b.std() + 1e-8))


def hu_loss(x: torch.Tensor, mask: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    below = (torch.clamp(x, max=lo) - lo) ** 2
    above = (torch.clamp(x, min=hi) - hi) ** 2
    return ((below + above) * mask).sum() / (mask.sum() + 1e-8)


def schedule(start: int, length: int, critic_every: int, generator_every: int) -> List[str]:
    out = []
    for i in range(start, start + length):
        c, g = i % critic_every == 0, i % generator_every == 0
        out.append("combined" if c and g else "critic" if c else "generator" if g else "none")
    return out


def train(gen_params: Dict[str, torch.Tensor], critic_params: Dict[str, torch.Tensor], cycles, cfg: dict,
          prec: Optional[str] = None) -> dict:
    """Run ``cycles`` (a list of cycles, each a list of (opt, sub, mask)
    int16 batches, one per iteration) from the given weights, which are
    copied. ``cfg``: ``generator`` and ``critic`` architecture dicts and the
    ``train`` hyperparameters of a benchmark configuration. Returns per
    cycle the losses (``D`` the mean over the cycle's critic updates, the
    others the cycle's last generator update), both optimizers' first
    moments after it (``moments``); and the weights after the last cycle."""
    g_arch, c_arch, t = cfg["generator"], cfg["critic"], cfg["train"]
    Pg = {k: v.detach().clone().requires_grad_(True) for k, v in gen_params.items()}
    Pd = {k: v.detach().clone().requires_grad_(True) for k, v in critic_params.items()}
    opt_g = Adam(Pg, t["lr"], t["betas"])
    opt_d = Adam(Pd, t["lr"], t["betas"])
    lo, hi = (float(model.scale(torch.tensor(float(b)))) for b in t["hu_bounds"])
    clip = t["weight_clip"]

    def G(x):
        return model.generator(Pg, x, g_arch["n_resnet_blocks"], g_arch["n_updownsample_blocks"], train=True,
                               prec=prec)

    def D(x):
        return model.critic(Pd, x, c_arch["discriminator_depth"], prec=prec)

    def update_critic(real, fake):
        loss = D(fake).mean() - D(real).mean()
        grads = torch.autograd.grad(loss, list(Pd.values()))
        opt_d.step(dict(zip(Pd, grads)))
        with torch.no_grad():
            for p in Pd.values():
                p.clamp_(-clip, clip)
        return loss.detach()

    out = {"losses": [], "moments": []}
    it = 0
    for cycle in cycles:
        metrics, d_losses = {}, []
        for branch, (opt, sub, mask) in zip(schedule(it, len(cycle), t["critic_every"], t["generator_every"]),
                                            cycle):
            it += 1
            real, x, m = model.scale(opt).unsqueeze(1), model.scale(sub).unsqueeze(1), mask.float().unsqueeze(1)
            if branch == "critic":
                with torch.no_grad():
                    opt_hat = x - G(x)
                d_losses.append(update_critic(real, opt_hat))
            elif branch in ("combined", "generator"):
                opt_hat = x - G(x)
                if branch == "combined":
                    d_losses.append(update_critic(real, opt_hat.detach()))
                loss_g = -D(opt_hat).mean()
                sim = zncc_loss(opt_hat, x)
                hu = hu_loss(opt_hat, m, lo, hi)
                full = loss_g + sim + hu
                grads = torch.autograd.grad(full, list(Pg.values()))
                opt_g.step(dict(zip(Pg, grads)))
                metrics.update({"G": loss_g.detach(), "G-full": full.detach(), "sim": sim.detach(),
                                "HU": hu.detach()})
        if d_losses:
            metrics["D"] = torch.stack(d_losses).mean()
        out["losses"].append({k: float(v) for k, v in metrics.items()})
        out["moments"].append({"generator": {k: v.clone() for k, v in opt_g.m.items()},
                               "critic": {k: v.clone() for k, v in opt_d.m.items()}})
    out["generator"] = {k: v.detach() for k, v in Pg.items()}
    out["critic"] = {k: v.detach() for k, v in Pd.items()}
    return out
