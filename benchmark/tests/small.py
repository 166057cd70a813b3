"""The cells' configurations and mixes cut to sizes a CPU test run holds:
the published depth of the pipeline, narrow networks, small patches and
volumes. The port's preset takes the same cuts (``preset_overrides``)."""

import copy

from benchmark import spec as specs


def config(name: str, dtype: str = "float32") -> dict:
    cfg = copy.deepcopy(specs.config(specs.load_spec(), name))
    is_2d = len(cfg["train"]["patch"]) == 2
    ndim = 2 if is_2d else 3
    gen = {"n_resnet_blocks": 1, "n_updownsample_blocks": 2, "init_channels_out": 4}
    critic = {"init_channels_out": 4, "discriminator_depth": 2, "norm": "batch"}
    patch = [32, 32] if is_2d else [16, 16, 16]
    batch = {"opt": 8, "low": 4, "high": 4} if is_2d else {"opt": 2, "low": 1, "high": 1}
    cfg["generator"], cfg["critic"] = gen, critic
    cfg["train"].update(patch=patch, batch=batch, dtype=dtype)
    cfg["correct"].update(patch=patch, batch=8 if is_2d else 24, reference_batch=4)
    cfg["preset_overrides"] = {
        "generator_args": {**gen, "ndim": ndim},
        "critic_args": {"init_channels_out": 4, "discriminator_depth": 2, "negative_slope": 0.2, "ndim": ndim},
        "train_patch_size": tuple(patch), "val_patch_size": tuple(patch),
        "train_batch_size": {0: batch["opt"], -1: batch["low"], 1: batch["high"]},
        "compute_dtype": dtype,
    }
    return cfg


def mix(name: str) -> dict:
    out = specs.traffic(name)
    if out["loop"] == "correct_volumes":
        out = {**out, "volume_shape": [40, 36, 24]}
    return out


CELLS = {  # cell -> (configuration, mix)
    "train.basic_3d": ("basic_3d", "train_cycles"),
    "train.conf_2d": ("conf_2d", "train_cycles"),
    "correct.basic_3d.z400": ("basic_3d", "correct_z400"),
    "correct.conf_2d.z400": ("conf_2d", "correct_z400"),
}


def run(cell: str, seed: int = 12345, dtype: str = "float32", seconds: float = 0.5):
    from benchmark import run as runner

    cfg_name, mix_name = CELLS[cell]
    return runner.run_cell(cell, seed, seconds, False, "cpu", config=config(cfg_name, dtype), mix=mix(mix_name))
