"""Reference ``<iteration>.pt`` checkpoints, both ways (counterpart of
``contrast_gan_3d_tpu/utils/torch_port.py``).

The reference trains ``ResnetGenerator`` / ``PatchGANDiscriminator`` in
torch and saves ``{"iteration", "generator": state_dict, "discriminator":
None, ...}`` (reference ``trainer/Trainer.py:321-327``). Its modules are
named ``model.first``, ``model.downsampling.<i>``,
``model.resnet_backbone.<i>.block{0,1}``, ``model.upsampling.<j>``,
``model.last_conv`` (generator) and ``model.first``, ``model.middle.<n>``,
``model.last`` (critic), each block's norm ``normalization``. The port's
modules are torch modules too, so the weights map across by key alone, in
torch's layouts, with no kernel transpose or flip:

- ``<block>.conv.*`` <-> ``<block>.conv.*``, ``<block>.norm.*`` <->
  ``<block>.normalization.*`` (a torch BatchNorm also carries
  ``num_batches_tracked``, which the port's BatchNorm has no use for: it is
  dropped on the way in and written as 0 on the way out, as the JAX
  exporter writes it);
- the reference's ``upsampling.<j>`` runs wide to narrow, the port's
  ``up_<i>`` counts channels down: ``upsampling.<j>`` is ``up_<n-1-j>``;
- the projection and the critic's last conv carry no block:
  ``model.last_conv.weight`` <-> ``last_conv.conv.weight``.

The reference's transpose convs place their window as torch does, so a
generator that loads a reference file is built with
``tconv_placement="torch"``. Block counts and ``ndim`` come from the state
dict; explicit values that disagree raise (a silent mismatch would
truncate the model). Files written here keep the critic under
``critic_state_dict`` with ``discriminator: None``: the reference loader
calls ``load_state_dict`` for every non-None entry it knows, and it has no
``discriminator`` module.
"""

import re
from typing import Dict, Mapping, Optional

import torch

from contrast_gan_3d_tpu_torch.models.discriminator import PatchGANDiscriminator
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator

_BN_TRACKED = "num_batches_tracked"


def _count_indexed(keys, prefix: str) -> int:
    """Number of distinct ``<prefix><i>.`` submodules among ``keys``."""
    return len({m.group(1) for k in keys if (m := re.match(re.escape(prefix) + r"(\d+)\.", k))})


def _check_count(requested: Optional[int], found: int, what: str) -> int:
    if requested is not None and requested != found:
        raise ValueError(f"{what}={requested} does not match the state_dict (found {found})")
    return found


def _generator_names(n_updownsample_blocks: int) -> Dict[str, str]:
    """Port module prefix -> reference module prefix, for the blocks."""
    names = {"first": "model.first"}
    for i in range(n_updownsample_blocks):
        names[f"down_{i}"] = f"model.downsampling.{i}"
        names[f"up_{n_updownsample_blocks - 1 - i}"] = f"model.upsampling.{i}"
    return names


def _block_key(port_key: str, names: Mapping[str, str]) -> str:
    """One port generator key -> its reference key."""
    module, rest = port_key.split(".", 1)
    if module == "last_conv":
        return f"model.last_conv.{rest.removeprefix('conv.')}"
    if module.startswith("resnet_"):
        block, rest = rest.split(".", 1)
        module = f"model.resnet_backbone.{module.removeprefix('resnet_')}.{block}"
    else:
        module = names[module]
    return f"{module}.{rest.replace('norm.', 'normalization.', 1)}"


def _critic_key(port_key: str) -> str:
    module, rest = port_key.split(".", 1)
    if module == "last":
        return f"model.last.{rest.removeprefix('conv.')}"
    if module.startswith("middle_"):
        module = f"middle.{module.removeprefix('middle_')}"
    return f"model.{module}.{rest.replace('norm.', 'normalization.', 1)}"


def _to_reference(state_dict: Mapping[str, torch.Tensor], key_fn) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in state_dict.items():
        ref = key_fn(k)
        out[ref] = v.detach().cpu().clone()
        if ref.endswith(".normalization.running_var"):
            out[ref.removesuffix("running_var") + _BN_TRACKED] = torch.tensor(0, dtype=torch.int64)
    return out


def _from_reference(state_dict: Mapping, key_fn, port_keys) -> Dict[str, torch.Tensor]:
    """The port ``state_dict`` for ``port_keys`` read out of a reference one;
    KeyError names what the file lacks."""
    missing = [key_fn(k) for k in port_keys if key_fn(k) not in state_dict]
    if missing:
        raise KeyError(f"the reference state_dict lacks {missing[:5]}")
    return {k: torch.as_tensor(state_dict[key_fn(k)]).detach().to(torch.float32).clone() for k in port_keys}


def generator_arch(state_dict: Mapping, n_resnet_blocks: Optional[int] = None,
                   n_updownsample_blocks: Optional[int] = None) -> dict:
    """A reference generator's architecture from its ``state_dict``: block
    counts from the ``resnet_backbone`` / ``downsampling`` keys, the stem
    width and ``ndim`` from ``model.first.conv.weight`` ``(O, I, *k)``."""
    stem = state_dict["model.first.conv.weight"]
    return {
        "n_resnet_blocks": _check_count(
            n_resnet_blocks, _count_indexed(state_dict, "model.resnet_backbone."), "n_resnet_blocks"),
        "n_updownsample_blocks": _check_count(
            n_updownsample_blocks, _count_indexed(state_dict, "model.downsampling."), "n_updownsample_blocks"),
        "init_channels_out": int(stem.shape[0]),
        "ndim": stem.dim() - 2,
    }


def critic_arch(state_dict: Mapping, discriminator_depth: Optional[int] = None) -> dict:
    """A reference critic's depth, stem width, kernel size, ``ndim`` and
    norm: "batch" where its middle blocks carry ``normalization`` weights,
    None where their convs carry a bias (an unnormalized block has one),
    else "layer" (no affine, no bias)."""
    stem = state_dict["model.first.conv.weight"]
    depth = _check_count(discriminator_depth, _count_indexed(state_dict, "model.middle."), "discriminator_depth")
    if "model.middle.0.normalization.weight" in state_dict:
        norm = "batch"
    elif depth == 0 or "model.middle.0.conv.bias" in state_dict:
        norm = None
    else:
        norm = "layer"
    return {
        "discriminator_depth": depth,
        "init_channels_out": int(stem.shape[0]),
        "ndim": stem.dim() - 2,
        "kernel_size": int(stem.shape[-1]),
        "norm": norm,
    }


def generator_state_dict_from_reference(state_dict: Mapping, n_resnet_blocks: Optional[int] = None,
                                        n_updownsample_blocks: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """A reference ``ResnetGenerator.state_dict()`` -> the port's, loadable
    with ``load_state_dict(strict=True)`` into a port ``ResnetGenerator`` of
    the same architecture."""
    arch = generator_arch(state_dict, n_resnet_blocks, n_updownsample_blocks)
    names = _generator_names(arch["n_updownsample_blocks"])
    norm = "batch" if "model.first.normalization.weight" in state_dict else None
    with torch.device("meta"):
        keys = list(ResnetGenerator(**arch, norm=norm).state_dict())
    return _from_reference(state_dict, lambda k: _block_key(k, names), keys)


def critic_state_dict_from_reference(state_dict: Mapping,
                                     discriminator_depth: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """A reference ``PatchGANDiscriminator.state_dict()`` -> the port's."""
    with torch.device("meta"):
        keys = list(PatchGANDiscriminator(**critic_arch(state_dict, discriminator_depth)).state_dict())
    return _from_reference(state_dict, _critic_key, keys)


def generator_state_dict_to_reference(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port generator's ``state_dict`` -> a reference one."""
    names = _generator_names(_count_indexed(state_dict, "down_"))
    return _to_reference(state_dict, lambda k: _block_key(k, names))


def critic_state_dict_to_reference(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port critic's ``state_dict`` -> a reference one."""
    return _to_reference(state_dict, _critic_key)


def load_reference_checkpoint(path, n_resnet_blocks: Optional[int] = None,
                              n_updownsample_blocks: Optional[int] = None,
                              discriminator_depth: Optional[int] = None) -> dict:
    """Read a reference ``<iteration>.pt`` (``torch.load(map_location="cpu",
    weights_only=True)``: such a file holds only tensors, ints and None).

    Returns ``{"iteration", "generator": port state_dict, "generator_arch",
    "critic": port state_dict or None, "critic_arch": dict or None}``. The
    critic is read from ``critic_state_dict`` (files written here and by
    the JAX package), ``discriminator`` or ``critic``; genuine reference
    files hold none (their save list names an attribute that does not
    exist)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    gsd = ckpt["generator"]
    out = {
        "iteration": int(ckpt.get("iteration", 0)),
        "generator": generator_state_dict_from_reference(gsd, n_resnet_blocks, n_updownsample_blocks),
        "generator_arch": generator_arch(gsd),
        "critic": None,
        "critic_arch": None,
    }
    critic_sd = next((ckpt[k] for k in ("critic_state_dict", "discriminator", "critic") if ckpt.get(k) is not None),
                     None)
    if critic_sd is not None:
        out["critic"] = critic_state_dict_from_reference(critic_sd, discriminator_depth)
        out["critic_arch"] = critic_arch(critic_sd, discriminator_depth)
    return out


def save_reference_checkpoint(path, generator_state_dict: Mapping[str, torch.Tensor],
                              critic_state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                              iteration: int = 0) -> None:
    """Write a reference-format ``<iteration>.pt`` from the port's state
    dicts (``module.state_dict()``), the critic, if given, under
    ``critic_state_dict``. A generator trained with the "same" transpose
    conv placement drives the reference model one voxel off: train with
    ``tconv_placement="torch"`` for files the reference reproduces
    exactly."""
    ckpt = {
        "iteration": int(iteration),
        "generator": generator_state_dict_to_reference(generator_state_dict),
        "discriminator": None,
    }
    if critic_state_dict is not None:
        ckpt["critic_state_dict"] = critic_state_dict_to_reference(critic_state_dict)
    torch.save(ckpt, path)
