"""Carry JAX ``ResnetGenerator`` and ``PatchGANDiscriminator`` variables
into the port's ``state_dict``.

The JAX variables are ``{"params": ..., "batch_stats": ...}`` nested dicts
of numpy arrays with flax paths such as ``first/Conv_0/kernel``,
``resnet_0/ConvBlock_1/BatchNorm_0/scale``, ``up_0/ConvTranspose_0/kernel``
or, for the critic, ``middle_0/BatchNorm_0/scale`` and ``last/Conv_0/bias``.
The mapping is layout-only:

- conv kernels ``(*k, I, O)`` -> ``(O, I, *k)``, 3D ``k = (kx, ky, kz)``
  or 2D ``(kx, ky)``;
- transpose-conv kernels: spatial flip, then ``(I, O, *k)`` — torch's
  transpose conv correlates with the flipped kernel (the window placement
  is the module's ``tconv_placement``, not a weight property);
- a LayerNorm has no variables (no affine), so ``norm="layer"`` blocks
  carry only their conv;
- BatchNorm ``scale``/``bias`` params and ``mean``/``var`` stats ->
  ``weight``/``bias``/``running_mean``/``running_var``;
- an instance norm (flax ``GroupNorm_0``) has ``scale``/``bias`` params
  only -> ``weight``/``bias``.
"""

from typing import Dict, Mapping

import numpy as np
import torch

_MODULE_NAMES = {
    "Conv_0": "conv",
    "ConvTranspose_0": "conv",
    "BatchNorm_0": "norm",
    "GroupNorm_0": "norm",
    "ConvBlock_0": "block0",
    "ConvBlock_1": "block1",
}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _conv_kernel(k: np.ndarray) -> np.ndarray:
    """(*k, I, O) -> (O, I, *k)."""
    nd = k.ndim - 2
    return k.transpose(nd + 1, nd, *range(nd))


def _tconv_kernel(k: np.ndarray) -> np.ndarray:
    """(*k, I, O) -> spatially flipped (I, O, *k)."""
    nd = k.ndim - 2
    return k[(slice(None, None, -1),) * nd].transpose(nd, nd + 1, *range(nd))


def _walk(tree: Mapping, path=()):
    for name, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, path + (name,))
        else:
            yield path + (name,), np.asarray(v)


def _module_path(path) -> str:
    return ".".join(_MODULE_NAMES.get(p, p) for p in path)


def generator_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``ResnetGenerator`` variables (numpy) -> the port's ``state_dict``,
    loadable with ``load_state_dict(strict=True)`` into a port
    ``ResnetGenerator`` of the same architecture."""
    return state_dict_from_jax(variables)


def critic_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``PatchGANDiscriminator`` variables (numpy) -> the port's
    ``state_dict``, loadable with ``load_state_dict(strict=True)`` into a
    port ``PatchGANDiscriminator`` of the same architecture (``first/Conv_0``
    -> ``first.conv``, ``middle_{n}/BatchNorm_0`` -> ``middle_{n}.norm``)."""
    return state_dict_from_jax(variables)


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Any flax variables of these networks -> torch names and layouts; a
    tree shaped like the parameters (optax's ``mu`` / ``nu``) maps as
    ``{"params": tree}``."""
    sd: Dict[str, np.ndarray] = {}
    for path, v in _walk(variables["params"]):
        *mods, leaf = path
        if leaf == "kernel":
            v = _tconv_kernel(v) if mods[-1] == "ConvTranspose_0" else _conv_kernel(v)
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        elif leaf != "bias":
            raise ValueError(f"unexpected parameter {'/'.join(path)}")
        sd[f"{_module_path(mods)}.{leaf}"] = v
    for path, v in _walk(variables.get("batch_stats") or {}):
        *mods, leaf = path
        if leaf not in _STAT_NAMES:
            raise ValueError(f"unexpected batch stat {'/'.join(path)}")
        sd[f"{_module_path(mods)}.{_STAT_NAMES[leaf]}"] = v
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}
