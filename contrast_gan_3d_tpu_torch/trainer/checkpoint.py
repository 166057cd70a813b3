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
and a failed write raises at the next save. Reading the JAX package's
msgpack checkpoints and the reference ``.pt`` layout is not ported
(ROADMAP).
"""

import json
import logging
import pickle
import re
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

logger = logging.getLogger(__name__)

_CKPT_RE = re.compile(r"^(\d+)\.pt$")
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


def find_latest_checkpoint(ckpt_dir) -> Optional[Path]:
    """The highest-step ``<step>.pt`` in ``ckpt_dir``, or None."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.is_dir():
        return None
    steps = [(int(m.group(1)), p) for p in ckpt_dir.iterdir() if (m := _CKPT_RE.match(p.name))]
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


def state_payload(state) -> Dict:
    """The train state as a host-side dict of plain containers and
    tensors."""
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
        "rng": state.rng.get_state(),
    })


def save_checkpoint(state, ckpt_dir, step: Optional[int] = None, keep: Optional[int] = None,
                    async_: bool = False, meta: Optional[Dict] = None) -> Path:
    """Write ``state`` to ``<ckpt_dir>/<step>.pt`` atomically. ``keep``:
    retain the newest N checkpoints (and their sidecars). ``async_``: copy
    to the host now, write on a thread. ``meta``: a JSON-able dict written
    to ``<step>.meta.json``."""
    if keep is not None and keep <= 0:
        raise ValueError(f"keep must be a positive count, got {keep}")
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    step = int(state.step) if step is None else int(step)
    path = checkpoint_path(ckpt_dir, step)
    payload = state_payload(state)
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
    """Load a :func:`state_payload` dict into ``state`` in place."""
    state.generator.load_state_dict(payload["generator"], strict=True)
    state.critic.load_state_dict(payload["critic"], strict=True)
    for opt, o_key, s_key in ((state.gen_opt, "gen_opt", "gen_schedule"),
                              (state.critic_opt, "critic_opt", "critic_schedule")):
        opt.load_state_dicts(payload[o_key], payload[s_key])
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


def load_generator(ckpt_dir_or_file, iteration: Optional[int] = None) -> Dict:
    """What inference needs: the generator's ``state_dict`` (statistics
    included), the step and the meta sidecar."""
    path = Path(ckpt_dir_or_file)
    if path.is_dir():
        path = checkpoint_path(path, iteration) if iteration is not None else find_latest_checkpoint(path)
        if path is None or not path.exists():
            raise FileNotFoundError(f"No checkpoint in {ckpt_dir_or_file}")
    payload = _load(path)
    meta_file = meta_path(path.parent, int(path.stem))
    return {
        "state_dict": payload["generator"],
        "step": int(payload["step"]),
        "meta": json.loads(meta_file.read_text()) if meta_file.is_file() else {},
    }
