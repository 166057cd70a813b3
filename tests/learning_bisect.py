"""Bisect the learning check between the JAX package and the port on the CPU
(ROADMAP C7). Not a test module (pytest does not collect it): a command
that imports both packages, kept as the origin of the C7 numbers in
PERF.md (the 800-iteration runs at seeds 0-6 and the one-step gradient
distances). What of it must keep holding is a test:
``tests/test_torch_port_learning_trajectory.py`` runs the first 20
iterations of the same recipe on both sides and holds the bf16 bias
gradient the bisect found.

    python tests/learning_bisect.py run jax  800 wd/jax_bf16_3 --seed 3
    python tests/learning_bisect.py run port 800 wd/port_bf16_3 --seed 3
    python tests/learning_bisect.py run jax  30 wd/j --f32 --cycle 1 --ckpt-every 1
    python tests/learning_bisect.py compare wd/j wd/p
    python tests/learning_bisect.py table wd --seeds 0 1 2 3 4 5 6
    python tests/learning_bisect.py grads --seed 3 --layout packed

``run`` trains one side with ``validate_learning``'s recipe (its cohort,
16^3 patches, widths, 4 + 2 + 2 batches, lr 1e-3, host augmentation, one
loader thread per label so both sides see the same batches), the port
from JAX's initial weights; it keeps a checkpoint every ``--ckpt-every``
iterations and writes the held-out LOW / HIGH centerline HU to
``<workdir>/summary.json``. ``compare`` prints, per common step, the
largest and RMS weight difference and the largest BatchNorm-statistic
difference of two runs (either side's checkpoints). ``table`` prints the
LOW / HIGH after 800 iterations of ``<dir>/{jax,port}_{bf16,f32}_<seed>``.
``grads`` takes one ``combined_step`` with SGD at lr 1 from JAX's initial
weights on one batch in JAX f32 / bf16 and the port f32 / bf16 and prints
each generator gradient tensor's distance from JAX's f32 one.
"""

import argparse
import json
import re
import sys
from dataclasses import replace
from functools import partial
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from flax import serialization  # noqa: E402

from contrast_gan_3d_tpu.data import preprocess as jax_preprocess  # noqa: E402
from contrast_gan_3d_tpu.experiments import config as jax_config  # noqa: E402
from contrast_gan_3d_tpu.experiments.builder import build as jax_build  # noqa: E402
from contrast_gan_3d_tpu.trainer import steps as jax_steps  # noqa: E402
from contrast_gan_3d_tpu_torch.experiments import config as port_config  # noqa: E402
from contrast_gan_3d_tpu_torch.utils.weights import (  # noqa: E402
    critic_state_dict_from_jax,
    generator_state_dict_from_jax,
)
from contrast_gan_3d_tpu_torch.validate_learning import VESSEL_HU, synth_patient  # noqa: E402

SHAPE, PATCH = (32, 32, 32), (16, 16, 16)
GEN = {"n_resnet_blocks": 2, "n_updownsample_blocks": 1, "init_channels_out": 8}
CRITIC = {"init_channels_out": 4, "discriminator_depth": 2}


def recipe(module, a):
    return replace(module.load_config("basic_3d"), train_iterations=a.iterations, validate_every=None,
                   checkpoint_every=a.ckpt_every, checkpoint_keep=None, log_every=5, log_images_every=None,
                   train_patch_size=PATCH, train_batch_size={0: 4, -1: 2, 1: 2}, generator_args=GEN,
                   critic_args=CRITIC, lr=1e-3, milestones=(), logger="none", cycle_length=a.cycle, seed=a.seed,
                   **({"compute_dtype": "float32"} if a.f32 else {}))


def _tree(t):
    return jax.tree.map(np.asarray, t)


def run(a):
    wd = a.workdir
    rng = np.random.default_rng(0)
    fold = []
    for label, hu in VESSEL_HU.items():
        for i in range(3):
            vol, mask, meta = synth_patient(rng, SHAPE, hu)
            fold.append((str(jax_preprocess.write_patient(vol, mask, meta, f"s{label}_{i}", wd / "data")), label))
    jcfg = recipe(jax_config, a)
    jb = jax_build(jcfg, checkpoint_dir=str(wd / "ckpt"))
    key = jax.random.key(jb.seed)
    if a.side == "jax":
        from contrast_gan_3d_tpu.data.pipeline import create_loaders
        from contrast_gan_3d_tpu.eval.corrector import CCTAContrastCorrector
        from contrast_gan_3d_tpu.trainer.trainer import Trainer

        Trainer(jb.generator, jb.critic, jb.gen_tx, jb.critic_tx, jb.step_config, jb.trainer_config, key, PATCH,
                logger_interface=jb.logger_interface).fit(create_loaders(
                    fold, PATCH, jcfg.train_batch_size, np.random.default_rng(jb.seed), num_threads=1,
                    augmenter=jb.host_augmenter))
        corrector = CCTAContrastCorrector.from_checkpoint(wd / "ckpt", generator=jb.generator,
                                                          inference_patch_size=PATCH, batch_size=4)
        correct = lambda v: np.asarray(corrector(v))
    else:
        from contrast_gan_3d_tpu_torch.data.pipeline import create_loaders
        from contrast_gan_3d_tpu_torch.eval.corrector import CCTAContrastCorrector
        from contrast_gan_3d_tpu_torch.experiments.builder import build
        from contrast_gan_3d_tpu_torch.trainer.trainer import Trainer
        from contrast_gan_3d_tpu_torch.utils.device import full_f32

        s0 = jax_steps.init_state(jb.generator, jb.critic, jb.gen_tx, jb.critic_tx, key, PATCH)
        cfg = recipe(port_config, a)
        b = build(cfg, checkpoint_dir=str(wd / "ckpt"), device="cpu")
        b.generator.load_state_dict(generator_state_dict_from_jax(
            {"params": _tree(s0.gen_params), "batch_stats": _tree(s0.gen_stats)}))
        b.critic.load_state_dict(critic_state_dict_from_jax(
            {"params": _tree(s0.critic_params), "batch_stats": _tree(s0.critic_stats)}))
        with full_f32():
            Trainer(b.generator, b.critic, b.gen_tx, b.critic_tx, b.step_config, b.trainer_config, seed=b.seed,
                    logger_interface=b.logger_interface, device="cpu").fit(create_loaders(
                        fold, PATCH, cfg.train_batch_size, np.random.default_rng(b.seed), num_threads=1,
                        augmenter=b.host_augmenter, device="cpu"))
        corrector = CCTAContrastCorrector.from_checkpoint(wd / "ckpt", generator=b.generator,
                                                          inference_patch_size=PATCH, batch_size=4, device="cpu")
        correct = lambda v: corrector(v).cpu().numpy()
    summary = {"side": a.side, "seed": a.seed, "iterations": a.iterations, "f32": a.f32}
    for tag, hu in (("low", 250), ("high", 550)):
        vol, mask, _ = synth_patient(rng, SHAPE, hu)
        m = mask.astype(bool)
        summary[f"{tag}_before"], summary[f"{tag}_after"] = float(vol[m].mean()), float(correct(vol)[m].mean())
    print(json.dumps(summary))
    (wd / "summary.json").write_text(json.dumps(summary))


def _checkpoints(d: Path) -> dict:
    out = {}
    for p in (d / "ckpt").iterdir():
        m = re.match(r"^(\d+)\.(msgpack|pt)$", p.name)
        if not m:
            continue
        if m.group(2) == "pt":
            payload = torch.load(p, weights_only=True)
            nets = {"G": payload["generator"], "D": payload["critic"]}
        else:
            raw = serialization.msgpack_restore(p.read_bytes())
            nets = {"G": generator_state_dict_from_jax({"params": raw["gen_params"], "batch_stats": raw["gen_stats"]}),
                    "D": critic_state_dict_from_jax({"params": raw["critic_params"],
                                                     "batch_stats": raw["critic_stats"] or {}})}
        out[int(m.group(1))] = {n: {k: v.numpy() for k, v in sd.items()} for n, sd in nets.items()}
    return out


def compare(a):
    x, y = _checkpoints(a.a), _checkpoints(a.b)
    stat = lambda k: k.endswith(("running_mean", "running_var"))
    for s in sorted(set(x) & set(y)):
        row = [f"step {s:4d}"]
        for n in ("G", "D"):
            d = {k: x[s][n][k] - y[s][n][k] for k in x[s][n]}
            w = np.concatenate([v.ravel() for k, v in d.items() if not stat(k)])
            st = max([np.abs(v).max() for k, v in d.items() if stat(k)] or [0.0])
            row.append(f"{n} max {np.abs(w).max():.3e} rms {np.sqrt(np.mean(w ** 2)):.3e} stats {st:.3e}")
        print(" | ".join(row))


def table(a):
    for group in ("jax_bf16", "jax_f32", "port_bf16", "port_f32"):
        got = [json.loads(f.read_text()) for s in a.seeds if (f := a.dir / f"{group}_{s}" / "summary.json").exists()]
        highs = [g["high_after"] for g in got]
        print(f"{group:10s}", "  ".join(f"{g['low_after']:.1f}/{g['high_after']:.1f}" for g in got),
              f" HIGH {min(highs):.1f}-{max(highs):.1f}" if highs else "")


def grads(a):
    from contrast_gan_3d_tpu.data.scaler import FactorZeroCenterScaler as JaxScaler
    from contrast_gan_3d_tpu.models.discriminator import PatchGANDiscriminator as JaxCritic
    from contrast_gan_3d_tpu.models.generator import ResnetGenerator as JaxGenerator
    from contrast_gan_3d_tpu.trainer import optim as jax_optim
    from contrast_gan_3d_tpu_torch.data.scaler import FactorZeroCenterScaler
    from contrast_gan_3d_tpu_torch.models.discriminator import PatchGANDiscriminator
    from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
    from contrast_gan_3d_tpu_torch.trainer import steps as port_steps
    from contrast_gan_3d_tpu_torch.trainer.optim import make_optimizer

    rng = np.random.default_rng(a.seed)
    vols = {label: [synth_patient(rng, SHAPE, hu) for _ in range(3)] for label, hu in VESSEL_HU.items()}

    def crop(label, n):
        cut = [(vols[label][i % 3], rng.integers(0, 16, 3)) for i in range(n)]
        return [np.stack([v[k][x:x + 16, y:y + 16, z:z + 16] for (v, (x, y, z)) in cut]) for k in (0, 1)]

    opt = crop(0, 4)[0]
    (lo, lom), (hi, him) = crop(-1, 2), crop(1, 2)
    sub, mask = np.concatenate([lo, hi]), np.concatenate([lom, him]).astype(np.int16)
    kg, kc, _ = jax.random.split(jax.random.key(a.seed), 3)
    zeros = jnp.zeros((1, *PATCH, 1))
    g0, c0 = _tree(JaxGenerator(**GEN).init(kg, zeros, train=False)), _tree(JaxCritic(**CRITIC).init(kc, zeros,
                                                                                                      train=False))
    common = dict(weight_clip=0.01, hu_bounds=(350.0, 450.0))

    def jax_run(dtype):
        tx = jax_optim.make_optimizer("sgd", lr=1.0)
        cfg = jax_steps.StepConfig(augment=None, dtype=dtype, scaler=JaxScaler(-1024, 1500, 600), **common)
        st = jax_steps.GANTrainState(
            step=jnp.zeros((), jnp.int32), gen_params=g0["params"], gen_stats=g0["batch_stats"],
            critic_params=c0["params"], critic_stats=c0["batch_stats"], gen_opt=tx.init(g0["params"]),
            critic_opt=tx.init(c0["params"]), rng=jax.random.key(a.seed))
        steps = jax_steps.build_train_steps(JaxGenerator(**GEN, dtype=dtype, layout=a.layout),
                                            JaxCritic(**CRITIC, dtype=dtype), tx, tx, cfg)
        st, _ = steps.combined_step(st, jnp.asarray(opt), jnp.asarray(sub), jnp.asarray(mask))
        return {k: v.numpy() for k, v in generator_state_dict_from_jax({"params": _tree(st.gen_params)}).items()}

    def port_run(dtype):
        gen, critic = ResnetGenerator(**GEN, dtype=dtype, layout=a.layout), PatchGANDiscriminator(**CRITIC, dtype=dtype)
        gen.load_state_dict(generator_state_dict_from_jax(g0))
        critic.load_state_dict(critic_state_dict_from_jax(c0))
        tx = partial(make_optimizer, "sgd", lr=1.0)
        st = port_steps.init_state(gen, critic, tx, tx, device="cpu")
        cfg = port_steps.StepConfig(dtype=dtype, scaler=FactorZeroCenterScaler(-1024, 1500, 600), **common)
        port_steps.build_train_steps(cfg).combined_step(st, opt, sub, mask)
        return {k: v.detach().numpy() for k, v in gen.named_parameters()}

    init = {k: v.numpy() for k, v in generator_state_dict_from_jax({"params": g0["params"]}).items()}
    after = {"J32": jax_run(jnp.float32), "J16": jax_run(jnp.bfloat16), "P32": port_run(torch.float32),
             "P16": port_run(torch.bfloat16)}
    g = {n: {k: init[k] - v for k, v in r.items()} for n, r in after.items()}
    rms = lambda v: float(np.sqrt(np.mean(v ** 2)))
    print(f"{'tensor':32s} {'rms g32':>9s} {'J16-J32':>9s} {'P16-J32':>9s} {'P32-J32':>9s}")
    for k in init:
        ref = g["J32"][k]
        print(f"{k:32s} {rms(ref):9.2e} " + " ".join(f"{rms(g[n][k] - ref):9.2e}" for n in ("J16", "P16", "P32")))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("side", choices=("jax", "port"))
    r.add_argument("iterations", type=int)
    r.add_argument("workdir", type=Path)
    r.add_argument("--seed", type=int, default=3)
    r.add_argument("--f32", action="store_true", help="train in f32 (default: basic_3d's bf16)")
    r.add_argument("--cycle", type=int, default=5)
    r.add_argument("--ckpt-every", type=int, default=5)
    c = sub.add_parser("compare")
    c.add_argument("a", type=Path)
    c.add_argument("b", type=Path)
    t = sub.add_parser("table")
    t.add_argument("dir", type=Path)
    t.add_argument("--seeds", type=int, nargs="+", default=list(range(7)))
    gr = sub.add_parser("grads")
    gr.add_argument("--seed", type=int, default=3)
    gr.add_argument("--layout", choices=("packed", "direct"), default="packed")
    a = p.parse_args(argv)
    {"run": run, "compare": compare, "table": table, "grads": grads}[a.cmd](a)


if __name__ == "__main__":
    main()
