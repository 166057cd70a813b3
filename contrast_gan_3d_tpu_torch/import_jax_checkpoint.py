"""Carry a JAX run's checkpoint into a port run, so ``train`` resumes it:

    python -m contrast_gan_3d_tpu_torch.import_jax_checkpoint jax_runs/exp1 runs/exp1 --conf basic_3d
    python -m contrast_gan_3d_tpu_torch.train --conf basic_3d --checkpoint-root runs --run-id exp1 ...

reads the latest ``<step>.msgpack`` of the JAX run directory (or
``--iteration``'s) without JAX or ``msgpack`` (``utils/msgpack.py``),
builds the run's networks and optimizers from ``--conf`` (the config the
JAX run trained with: a preset name or an override file, as ``train``
takes it) on the card unless ``--device cpu`` (either way the written file
resumes on the card or the CPU) and writes
``<out_dir>/<step>.pt`` with:
- both networks, weights and BatchNorm statistics (``utils/weights.py``);
- both optimizers' states: optax's Adam ``mu`` / ``nu`` / ``count``,
  RMSprop's ``nu``, none for SGD, and each schedule's update count;
- the step;
and no random generator state, so the run resumes on any device.

The JAX run's ``<step>.meta.json`` is copied beside it; a generator whose
``tconv_placement`` or ``norm`` differs from it raises. The random
generator starts fresh from the config's seed when ``train`` resumes: a
threefry key has no Philox counterpart (logged). The data-stream sidecars
(``<step>.data*.pkl``) are copied when they read as the port's (format 2:
plain dicts of the samplers' numpy states), so the streams resume;
otherwise they start fresh (logged). Returns the written checkpoint's path.
"""

import argparse
import logging
import pickle
import shutil
import sys
from pathlib import Path

from contrast_gan_3d_tpu_torch.experiments.builder import build
from contrast_gan_3d_tpu_torch.experiments.config import load_config
from contrast_gan_3d_tpu_torch.trainer import checkpoint as ckpt_lib
from contrast_gan_3d_tpu_torch.trainer.steps import init_state
from contrast_gan_3d_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("contrast_gan_3d_tpu_torch.import_jax_checkpoint")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("jax_dir", type=Path, help="the JAX run's checkpoint directory (or one <step>.msgpack)")
    p.add_argument("out_dir", type=Path, help="the port run's checkpoint directory (train's <root>/<run-id>)")
    p.add_argument("--conf", default=None, help="preset name or python override file the JAX run trained with")
    p.add_argument("--iteration", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu: the device that builds the state")
    return p.parse_args(argv)


def _readable_data_state(path: Path) -> bool:
    """Whether a JAX data-stream sidecar reads as the port's (format 2)."""
    try:
        payload = pickle.loads(path.read_bytes())
    except Exception as e:  # a class of the JAX package, a torn file
        logger.warning("Data-stream sidecar '%s' does not read here (%s)", path, e)
        return False
    return isinstance(payload, dict) and payload.get("format") == 2 and isinstance(payload.get("loaders"), dict)


def import_checkpoint(jax_dir, out_dir, cfg, iteration=None, device="cuda") -> Path:
    """Write the port checkpoint of ``jax_dir``'s (``iteration``'s or the
    latest) JAX checkpoint under ``out_dir``, the run built from ``cfg`` on
    ``device``."""
    path = ckpt_lib.jax_checkpoint_file(jax_dir, iteration)
    built = build(cfg, device=device)
    meta = ckpt_lib.read_meta(path)
    for key, value in meta.get("generator", {}).items():
        if getattr(built.generator, key, value) != value:
            raise ValueError(f"the JAX run's generator has {key}={value!r}, the config builds "
                             f"{getattr(built.generator, key)!r}")
    state = init_state(built.generator, built.critic, built.gen_tx, built.critic_tx, seed=built.seed, device=device)
    ckpt_lib.restore_jax_state(state, ckpt_lib.load_jax_state(path))
    logger.info("JAX checkpoint '%s' @ step %d carried; the random generator starts fresh from seed %d "
                "(a threefry key has no Philox counterpart)", path, state.step, built.seed)
    out = ckpt_lib.save_checkpoint(state, out_dir, meta=meta or None, rng=False)
    sidecars = sorted(path.parent.glob(f"{path.stem}.data*.pkl"))
    for sidecar in sidecars:
        if _readable_data_state(sidecar):
            shutil.copyfile(sidecar, Path(out_dir) / sidecar.name)
            logger.info("Data-stream sidecar '%s' copied: the streams resume", sidecar.name)
        else:
            logger.warning("Data-stream sidecar '%s' not copied: the streams start fresh", sidecar)
    if not sidecars:
        logger.warning("No data-stream sidecar beside '%s': the streams start fresh", path)
    return out


def main(argv=None) -> Path:
    args = parse_args(argv)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(name)s | %(levelname)s | %(message)s")
    return import_checkpoint(args.jax_dir, args.out_dir, load_config(args.conf), args.iteration,
                             resolve_device(args.device))


if __name__ == "__main__":
    main()
    sys.exit(0)
