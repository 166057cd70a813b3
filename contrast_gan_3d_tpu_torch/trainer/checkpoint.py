"""Checkpoint and resume of the whole train state (counterpart of
``contrast_gan_3d_tpu/trainer/checkpoint.py``), in the port's own format.

``<step>.pt`` (``torch.save``, loaded with ``weights_only=True``) holds both
networks' ``state_dict`` (BatchNorm statistics included), both optimizers
with their multistep schedules (``MultiStepLR``'s keys, the update count as
its ``last_epoch``), the ``torch.Generator`` state and the step.
Beside it: ``<step>.meta.json`` (module semantics for inference) and
``<step>.data.pkl``, the loaders' data-stream state (format 2, as the JAX
package writes it). Writes are atomic (tmp + rename) and optionally
asynchronous: the state is copied to the host first, a thread writes it,
and a failed write raises at the next save.

The JAX package's ``<step>.msgpack`` checkpoints are read without JAX or
``msgpack`` (``utils/msgpack.py``): ``load_jax_state`` returns the whole
tree, ``load_jax_generator`` what inference needs (JAX's
``load_generator``), and ``restore_jax_state`` carries the tree into a port
train state (the ``import_jax_checkpoint`` command writes it as a
``<step>.pt``). ``load_generator`` (the generator) and ``load_networks``
(both networks, the ``export_torch_checkpoint`` command's) read either
kind of run directory.
"""

import json
import logging
import pickle
import re
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

from contrast_gan_3d_tpu_torch.utils.msgpack import msgpack_restore
from contrast_gan_3d_tpu_torch.utils.weights import (
    critic_state_dict_from_jax,
    generator_state_dict_from_jax,
    state_dict_from_jax,
)

logger = logging.getLogger(__name__)

_CKPT_RE = re.compile(r"^(\d+)\.pt$")
_JAX_CKPT_RE = re.compile(r"^(\d+)\.msgpack$")
FORMAT = 1

# one in-flight async write per checkpoint directory, and the place its
# failure waits for the next save
_inflight_lock = threading.Lock()
_inflight: Dict[str, threading.Thread] = {}
_inflight_errors: Dict[str, BaseException] = {}


def flush_async_saves(ckpt_dir) -> None:
    """Join any in-flight async write for ``ckpt_dir``; raise its error."""
    key = str(Path(ckpt_dir))
    with _inflight_lock:
        t = _inflight.pop(key, None)
    if t is not None:
        t.join()
    with _inflight_lock:
        err = _inflight_errors.pop(key, None)
    if err is not None:
        raise RuntimeError(f"async checkpoint write under '{ckpt_dir}' failed") from err


def checkpoint_path(ckpt_dir, step: int) -> Path:
    return Path(ckpt_dir) / f"{int(step)}.pt"


def meta_path(ckpt_dir, step: int) -> Path:
    return Path(ckpt_dir) / f"{int(step)}.meta.json"


def data_state_path(ckpt_dir, step: int, host_index: int = 0, host_count: int = 1) -> Path:
    """``<step>.data.pkl``; a multi-host run writes one per host
    (``<step>.data.host<i>.pkl``: the hosts' fold shards differ), as the
    JAX package does."""
    host = "" if host_count == 1 else f".host{host_index}"
    return Path(ckpt_dir) / f"{int(step)}.data{host}.pkl"


def find_latest_checkpoint(ckpt_dir, pattern=_CKPT_RE) -> Optional[Path]:
    """The highest-step ``<step>.pt`` in ``ckpt_dir`` (``pattern``: the
    file names, ``<step>.msgpack`` for a JAX run), or None."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.is_dir():
        return None
    steps = [(int(m.group(1)), p) for p in ckpt_dir.iterdir() if (m := pattern.match(p.name))]
    return max(steps, key=lambda s: s[0])[1] if steps else None


def _host(obj):
    """A detached CPU copy of every tensor in a nested state dict."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def state_payload(state, rng: bool = True) -> Dict:
    """The train state as a host-side dict of plain containers and
    tensors; without the random generator's state where ``rng`` is false."""
    (gen_opt, gen_schedule), (critic_opt, critic_schedule) = (o.state_dicts() for o in (state.gen_opt,
                                                                                        state.critic_opt))
    return _host({
        "format": FORMAT,
        "step": int(state.step),
        "generator": state.generator.state_dict(),
        "critic": state.critic.state_dict(),
        "gen_opt": gen_opt,
        "gen_schedule": gen_schedule,
        "critic_opt": critic_opt,
        "critic_schedule": critic_schedule,
        **({"rng": state.rng.get_state()} if rng else {}),
    })


def save_checkpoint(state, ckpt_dir, step: Optional[int] = None, keep: Optional[int] = None,
                    async_: bool = False, meta: Optional[Dict] = None, rng: bool = True) -> Path:
    """Write ``state`` to ``<ckpt_dir>/<step>.pt`` atomically. ``keep``:
    retain the newest N checkpoints (and their sidecars). ``async_``: copy
    to the host now, write on a thread. ``meta``: a JSON-able dict written
    to ``<step>.meta.json``. ``rng=False`` leaves the random generator's
    state out: a resume keeps the generator as its config seeded it, on
    whatever device it runs."""
    if keep is not None and keep <= 0:
        raise ValueError(f"keep must be a positive count, got {keep}")
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    step = int(state.step) if step is None else int(step)
    path = checkpoint_path(ckpt_dir, step)
    payload = state_payload(state, rng)
    flush_async_saves(ckpt_dir)  # one write at a time; raises a failed one
    dir_key = str(ckpt_dir)

    def _write():
        tmp = path.with_name(f".{path.name}.{threading.get_ident()}.tmp")
        torch.save(payload, tmp)
        tmp.rename(path)
        if meta is not None:
            mp = meta_path(ckpt_dir, step)
            mp_tmp = mp.with_suffix(".json.tmp")
            mp_tmp.write_text(json.dumps(meta, indent=1))
            mp_tmp.rename(mp)
        logger.info("Saved checkpoint '%s'", path)
        if keep is not None:
            ckpts = sorted((p for p in ckpt_dir.iterdir() if _CKPT_RE.match(p.name)), key=lambda p: int(p.stem))
            for old in ckpts[:-keep]:
                old.unlink(missing_ok=True)
                for sidecar in ckpt_dir.glob(f"{old.stem}.data*.pkl"):
                    sidecar.unlink(missing_ok=True)
                meta_path(ckpt_dir, int(old.stem)).unlink(missing_ok=True)

    if async_:
        def _tracked_write():
            try:
                _write()
            except BaseException as e:  # raised at the next save or flush
                with _inflight_lock:
                    _inflight_errors[dir_key] = e
                logger.exception("async checkpoint write failed: %s", path)

        t = threading.Thread(target=_tracked_write, name=f"ckpt-{step}", daemon=True)
        with _inflight_lock:
            _inflight[dir_key] = t
        t.start()
    else:
        _write()
    return path


def _load(path: Path) -> Dict:
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        raise ValueError(f"'{path}' is not a checkpoint of this package (format {FORMAT})")
    return payload


def restore_state(state, payload: Dict):
    """Load a :func:`state_payload` dict into ``state`` in place (a payload
    without ``rng`` leaves ``state.rng`` as it was seeded)."""
    state.generator.load_state_dict(payload["generator"], strict=True)
    state.critic.load_state_dict(payload["critic"], strict=True)
    for opt, o_key, s_key in ((state.gen_opt, "gen_opt", "gen_schedule"),
                              (state.critic_opt, "critic_opt", "critic_schedule")):
        opt.load_state_dicts(payload[o_key], payload[s_key])
    if "rng" in payload:
        state.rng.set_state(payload["rng"])
    state.step = int(payload["step"])
    return state


def load_checkpoint(path_or_dir, state):
    """Restore ``state`` in place from a ``<step>.pt`` or the latest one in
    a directory."""
    path = Path(path_or_dir)
    if path.is_dir():
        latest = find_latest_checkpoint(path)
        if latest is None:
            raise FileNotFoundError(f"No checkpoint found in {path}")
        path = latest
    restore_state(state, _load(path))
    logger.info("Restored checkpoint '%s' @ step %d", path, state.step)
    return state


def maybe_restore(state, ckpt_dir):
    """Resume from the latest checkpoint in ``ckpt_dir`` if there is one."""
    flush_async_saves(ckpt_dir)
    latest = find_latest_checkpoint(ckpt_dir)
    return state if latest is None else load_checkpoint(latest, state)


def save_data_state(loaders: Dict, ckpt_dir, step: int, host_index: int = 0, host_count: int = 1) -> Path:
    """Write the loaders' stream states beside ``<step>.pt`` (this host's,
    in a multi-host run)."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    payload = {
        "format": 2,
        "process_count": host_count,
        "process_index": host_index,
        "loaders": {label: loader.get_state() for label, loader in loaders.items()},
    }
    path = data_state_path(ckpt_dir, step, host_index, host_count)
    tmp = path.with_suffix(".pkl.tmp")
    tmp.write_bytes(pickle.dumps(payload))
    tmp.rename(path)
    return path


def maybe_restore_data_state(loaders: Dict, ckpt_dir, step: int, host_index: int = 0, host_count: int = 1) -> bool:
    """Restore the loader states saved at ``step`` (loaders not started).
    True only when every loader's stream was restored; a missing sidecar,
    another host count, a missing loader or another patient list
    leaves those streams fresh, with a warning (the model restores
    either way)."""
    path = data_state_path(ckpt_dir, step, host_index, host_count)
    if not path.exists():
        others = sorted(Path(ckpt_dir).glob(f"{int(step)}.data*.pkl"))
        if others:
            logger.warning("No data-stream sidecar for this host at step %d, but %s exist (another host count); "
                           "starting fresh data streams", int(step), [p.name for p in others])
        return False
    payload = pickle.loads(path.read_bytes())  # written by save_data_state
    if isinstance(payload, dict) and payload.get("format") == 2:
        if payload["process_count"] != host_count:
            logger.warning("Data-stream sidecar '%s' was written by a %d-process run; starting fresh data streams",
                           path, payload["process_count"])
            return False
        states = payload["loaders"]
    else:
        states = payload
    missing = sorted(set(loaders) - set(states))
    if missing:
        logger.warning("Data-stream sidecar '%s' has no state for loaders %s; those start fresh", path, missing)
    stale = []
    for label, s in states.items():
        if label in loaders:
            try:
                loaders[label].set_state(s)
            except ValueError as e:  # saved for another patient list
                stale.append((label, str(e)))
    if stale:
        logger.warning("Data-stream sidecar '%s' does not match the patient lists; streams %s start fresh: %s",
                       path, [label for label, _ in stale], stale[0][1])
        return False
    if missing:
        return False
    logger.info("Restored data-stream state '%s'", path)
    return True


def _checkpoint_file(ckpt_dir_or_file, iteration: Optional[int]) -> Path:
    """The checkpoint file a path names: the file itself, or in a directory
    ``iteration``'s (or the latest) ``<step>.pt``, else the JAX package's
    ``<step>.msgpack``."""
    path = Path(ckpt_dir_or_file)
    if path.is_dir():
        pt = checkpoint_path(path, iteration) if iteration is not None else find_latest_checkpoint(path)
        return pt if pt is not None and pt.exists() else jax_checkpoint_file(path, iteration)
    if not path.exists():
        raise FileNotFoundError(f"No checkpoint {path}")
    return path


def read_meta(path: Path) -> Dict:
    """The ``<step>.meta.json`` beside a checkpoint file, or {}."""
    meta_file = meta_path(path.parent, int(path.stem))
    return json.loads(meta_file.read_text()) if meta_file.is_file() else {}


def load_generator(ckpt_dir_or_file, iteration: Optional[int] = None) -> Dict:
    """What inference needs: the generator's ``state_dict`` (statistics
    included), the step and the meta sidecar, from a port run's
    ``<step>.pt`` or a JAX run's ``<step>.msgpack`` (its weights carried by
    ``utils/weights.py``)."""
    nets = load_networks(ckpt_dir_or_file, iteration)
    if nets["path"].suffix == ".msgpack":
        logger.info("Read the JAX checkpoint '%s'", nets["path"])
    return {"state_dict": nets["generator"], "step": nets["step"], "meta": nets["meta"]}


def load_networks(ckpt_dir_or_file, iteration: Optional[int] = None) -> Dict:
    """Both networks of a port run's ``<step>.pt`` or a JAX run's
    ``<step>.msgpack``: ``generator`` and ``critic`` ``state_dict``s
    (statistics included, the JAX weights carried by ``utils/weights.py``),
    ``step``, ``meta`` and the file's ``path``: the file itself, or in a
    directory ``iteration``'s (or the latest) ``<step>.pt``, else
    ``<step>.msgpack``."""
    path = _checkpoint_file(ckpt_dir_or_file, iteration)
    if path.suffix == ".msgpack":
        tree = load_jax_state(path)
        nets = {prefix: carry({"params": tree[f"{prefix}_params"], "batch_stats": tree.get(f"{prefix}_stats") or {}})
                for prefix, carry in (("gen", generator_state_dict_from_jax), ("critic", critic_state_dict_from_jax))}
        generator, critic, step = nets["gen"], nets["critic"], tree["step"]
    else:
        payload = _load(path)
        generator, critic, step = payload["generator"], payload["critic"], payload["step"]
    return {"generator": generator, "critic": critic, "step": int(step), "meta": read_meta(path), "path": path}


def jax_checkpoint_file(ckpt_dir_or_file, iteration: Optional[int] = None) -> Path:
    """A JAX run's ``<step>.msgpack``: the file itself, or ``iteration``'s
    or the latest in a directory."""
    path = Path(ckpt_dir_or_file)
    if path.is_dir():
        path = path / f"{int(iteration)}.msgpack" if iteration is not None else find_latest_checkpoint(
            path, _JAX_CKPT_RE)
    if path is None or not path.exists():
        raise FileNotFoundError(f"No checkpoint in {ckpt_dir_or_file}")
    return path


def load_jax_state(ckpt_dir_or_file, iteration: Optional[int] = None) -> Dict:
    """The JAX package's whole train state from a ``<step>.msgpack``
    (:func:`jax_checkpoint_file`), as nested dicts of numpy arrays:
    ``step``, ``gen_params`` / ``gen_stats``, ``critic_params`` /
    ``critic_stats``, ``gen_opt`` / ``critic_opt`` (optax's states) and
    ``rng`` (the key's data)."""
    return msgpack_restore(jax_checkpoint_file(ckpt_dir_or_file, iteration).read_bytes())


def load_jax_generator(ckpt_dir_or_file, iteration: Optional[int] = None) -> Dict:
    """The counterpart of the JAX package's ``load_generator``: the
    generator's flax ``params`` and ``stats`` (numpy), the step and the
    ``<step>.meta.json`` sidecar (``tconv_placement``, ``norm``)."""
    path = jax_checkpoint_file(ckpt_dir_or_file, iteration)
    tree = load_jax_state(path)
    return {"params": tree["gen_params"], "stats": tree.get("gen_stats") or None, "step": int(tree["step"]),
            "meta": read_meta(path)}


def _optax_parts(tree: Dict) -> Dict[str, Dict]:
    """optax's chain state, as flax writes it (``{"0": ..., "1": ...}``),
    by role: ``moments`` (Adam's ``count`` / ``mu`` / ``nu``, RMSprop's
    ``nu``) and ``schedule`` (``scale_by_schedule``'s update ``count``)."""
    parts = [tree[k] for k in sorted(tree, key=int)]
    out = {"moments": next((p for p in parts if "nu" in p), None),
           "schedule": next((p for p in parts if set(p) == {"count"}), None)}
    if out["schedule"] is None:
        raise ValueError(f"no schedule count in the optax state {sorted(tree)}")
    return out


def _restore_optax(opt, module: torch.nn.Module, tree: Dict) -> None:
    """One optax state into a port ``ScheduledOptimizer`` over ``module``'s
    parameters: Adam's ``mu`` / ``nu`` / ``count`` -> ``exp_avg`` /
    ``exp_avg_sq`` / ``step``, RMSprop's ``nu`` -> ``square_avg`` (its
    ``step``: the update count), SGD none; the schedule's update count.
    The moments' kernels take the weights' layout changes."""
    parts = _optax_parts(tree)
    count = int(parts["schedule"]["count"])
    moments = parts["moments"]
    kind = type(opt.optimizer).__name__.lower().replace("_devicelr", "")
    wanted = {"adam": {"count", "mu", "nu"}, "rmsprop": {"nu"}, "sgd": None}[kind]
    if (set(moments) if moments is not None else None) != wanted:
        raise ValueError(f"the optax state {sorted(moments or [])} is not a {kind} state")
    sd, sched = opt.state_dicts()
    names = [name for name, _ in module.named_parameters()]
    if moments is not None:
        maps = {k: state_dict_from_jax({"params": moments[k]}) for k in ("mu", "nu") if k in moments}
        step = torch.tensor(float(moments.get("count", count)))
        for i, name in enumerate(names):
            sd["state"][i] = ({"step": step.clone(), "exp_avg": maps["mu"][name], "exp_avg_sq": maps["nu"][name]}
                              if kind == "adam" else {"step": step.clone(), "square_avg": maps["nu"][name]})
    sched["last_epoch"] = count
    opt.load_state_dicts(sd, sched)


def restore_jax_state(state, tree: Dict):
    """Carry a :func:`load_jax_state` tree into the port train state
    ``state`` in place: both networks (weights and BatchNorm statistics,
    strictly), both optimizers with their schedules' update counts, and the
    step. ``state.rng`` stays as it was seeded: a threefry key has no
    Philox counterpart."""
    for prefix, module, opt, carry in (("gen", state.generator, state.gen_opt, generator_state_dict_from_jax),
                                       ("critic", state.critic, state.critic_opt, critic_state_dict_from_jax)):
        module.load_state_dict(carry({"params": tree[f"{prefix}_params"],
                                      "batch_stats": tree.get(f"{prefix}_stats") or {}}), strict=True)
        _restore_optax(opt, module, tree[f"{prefix}_opt"])
    state.step = int(tree["step"])
    return state
