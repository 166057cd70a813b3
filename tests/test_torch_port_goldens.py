"""The port against the original PyTorch implementation's numbers without
its checkout: ``tests/goldens/reference_parity.json`` pins the reference
generator's and critic's outputs on seeded weights and inputs
(``tests/test_reference_parity.py``, which needs the reference checkout to
run). Here the reference-layout state dicts come from the port's own
networks through the reference ``.pt`` mapping
(``utils/reference_checkpoint.py``), are filled by
``fill_deterministic``'s recipe in sorted key order (so they hold the
golden run's weights), and are read back into the port, which runs the
golden inputs in eval mode: mean and std within 1e-4, the pinned values
within 1e-4, the goldens' own tolerances."""

import json
from pathlib import Path

import numpy as np
import torch

from contrast_gan_3d_tpu_torch.models.discriminator import PatchGANDiscriminator
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.utils import reference_checkpoint as ref_ckpt
from tests.test_reference_parity import fill_deterministic

GOLDENS = json.loads((Path(__file__).parent / "goldens" / "reference_parity.json").read_text())


class _ReferenceLayout:
    """A reference-layout state dict behind the two methods
    ``fill_deterministic`` calls."""

    def __init__(self, state_dict):
        self.sd = dict(state_dict)

    def state_dict(self):
        return dict(self.sd)

    def load_state_dict(self, sd):
        self.sd = dict(sd)


def _filled(port_module, to_reference, seed):
    layout = _ReferenceLayout(to_reference(port_module.state_dict()))
    fill_deterministic(layout, seed=seed)
    return layout.sd


def test_generator_matches_the_reference_goldens():
    sd = _filled(ResnetGenerator(), ref_ckpt.generator_state_dict_to_reference, seed=0)
    gen = ResnetGenerator(tconv_placement="torch", **ref_ckpt.generator_arch(sd))
    gen.load_state_dict(ref_ckpt.generator_state_dict_from_reference(sd), strict=True)
    x = np.random.default_rng(1).normal(0, 0.5, (2, 1, 32, 32, 32)).astype(np.float32)
    with torch.no_grad():
        got = gen.eval()(torch.from_numpy(x)).numpy()
    g = GOLDENS["generator_3d"]
    assert abs(float(got.mean()) - g["mean"]) < 1e-4
    assert abs(float(got.std()) - g["std"]) < 1e-4
    np.testing.assert_allclose(got[0, 0, :2, :2, :2].ravel(), np.asarray(g["corner"]), atol=1e-4)


def test_critic_matches_the_reference_goldens():
    sd = _filled(PatchGANDiscriminator(), ref_ckpt.critic_state_dict_to_reference, seed=4)
    critic = PatchGANDiscriminator(**ref_ckpt.critic_arch(sd))
    critic.load_state_dict(ref_ckpt.critic_state_dict_from_reference(sd), strict=True)
    x = np.random.default_rng(5).normal(0, 0.5, (2, 1, 32, 32, 32)).astype(np.float32)
    with torch.no_grad():
        got = critic.eval()(torch.from_numpy(x)).numpy()
    g = GOLDENS["critic_3d"]
    assert abs(float(got.mean()) - g["mean"]) < 1e-4
    np.testing.assert_allclose(got.ravel()[:8], np.asarray(g["first8"]), atol=1e-4)
