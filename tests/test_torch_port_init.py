"""The port's initial weights against flax's (C7), on the CPU.

A freshly built port generator and critic, 3D and 2D, both layouts, draw
every conv and transpose-conv kernel from flax's ``lecun_normal`` (a normal
cut at +-2 std, std ``sqrt(1 / fan_in) / 0.8796``, ``fan_in = in_ch *
prod(kernel)`` for both kinds) and every conv bias as zero, as the JAX
package's ``gen.init`` / ``critic.init`` of the same architecture do.
Tolerances: per leaf of at least 4096 entries, the port's std within 5% of
the JAX leaf's (and of ``sqrt(1 / fan_in)``; one draw of 4096+ values has a
sampling spread of about 1-2%); every value within the 2-std cut; biases
exactly zero.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from contrast_gan_3d_tpu.models.discriminator import PatchGANDiscriminator as JaxCritic
from contrast_gan_3d_tpu.models.generator import ResnetGenerator as JaxGenerator
from contrast_gan_3d_tpu_torch.models.discriminator import PatchGANDiscriminator
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.models.utils import TRUNCATED_NORMAL_STD, flax_fan_in, init_like_flax
from contrast_gan_3d_tpu_torch.utils.weights import critic_state_dict_from_jax, generator_state_dict_from_jax
from tests.test_torch_port_models import _np_tree

STD_TOL = 0.05
BIG = 4096
CONVS = (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d)
# (name, port builder, JAX module, carry, input spatial dims)
NETS = [
    ("generator 3D", lambda: ResnetGenerator(), JaxGenerator(), generator_state_dict_from_jax, (16, 16, 16)),
    ("generator 3D packed", lambda: ResnetGenerator(layout="packed"), JaxGenerator(layout="packed"),
     generator_state_dict_from_jax, (16, 16, 16)),
    ("generator 2D", lambda: ResnetGenerator(ndim=2), JaxGenerator(ndim=2), generator_state_dict_from_jax, (32, 32)),
    ("critic 3D", lambda: PatchGANDiscriminator(), JaxCritic(), critic_state_dict_from_jax, (32, 32, 32)),
    ("critic 3D no norm", lambda: PatchGANDiscriminator(norm=None), JaxCritic(norm=None), critic_state_dict_from_jax,
     (32, 32, 32)),
    ("critic 2D", lambda: PatchGANDiscriminator(ndim=2), JaxCritic(ndim=2), critic_state_dict_from_jax, (32, 32)),
]


@pytest.mark.parametrize("name,build,jax_module,carry,spatial", NETS, ids=[n[0] for n in NETS])
def test_fresh_weights_are_drawn_as_flax_draws_them(name, build, jax_module, carry, spatial):
    torch.manual_seed(0)
    port = build()
    # jitted: the same values as the eager init, in about half the time
    init = jax.jit(lambda key: jax_module.init(key, jnp.zeros((1, *spatial, 1)), train=False))
    variables = _np_tree(init(jax.random.key(0)))
    jax_sd = carry(variables)
    port_sd = port.state_dict()
    assert set(port_sd) == set(jax_sd)
    modules = dict(port.named_modules())
    checked = 0
    for key, value in port_sd.items():
        module = modules[key.rsplit(".", 1)[0]]
        got, want = value.float(), jax_sd[key].float()
        if isinstance(module, CONVS) and key.endswith("weight"):
            s = math.sqrt(1.0 / flax_fan_in(module))
            assert got.abs().max() <= 2 * s / TRUNCATED_NORMAL_STD * (1 + 1e-6), key
            if got.numel() >= BIG:
                checked += 1
                assert abs(got.std().item() / want.std().item() - 1) <= STD_TOL, (key, got.std(), want.std())
                assert abs(got.std().item() / s - 1) <= STD_TOL, (key, got.std(), s)
        else:  # conv biases, norm scales and biases, running statistics: as flax initialises them
            torch.testing.assert_close(got, want, rtol=0, atol=0, msg=key)
    assert checked >= 2  # the 2D critic has two kernels of 4096+ entries


def test_transpose_conv_fan_in_is_flax_s():
    """A transpose conv with in_ch != out_ch: torch's helper reads the
    ``(in, out, *k)`` weight's dim 1 (out) as the fan-in, flax's is in_ch *
    prod(kernel); the drawn std follows flax's."""
    torch.manual_seed(1)
    tconv = init_like_flax(nn.ConvTranspose3d(64, 16, 3, stride=2))
    torch_fan_in, _ = nn.init._calculate_fan_in_and_fan_out(tconv.weight)
    assert flax_fan_in(tconv) == 64 * 27 and torch_fan_in == 16 * 27
    flax_std, torch_std = math.sqrt(1 / (64 * 27)), math.sqrt(1 / (16 * 27))
    std = tconv.weight.std().item()
    assert abs(std / flax_std - 1) <= STD_TOL and abs(std / torch_std - 1) > 0.4
    jax_gen = JaxGenerator(n_updownsample_blocks=1, init_channels_out=32)
    init = jax.jit(lambda key: jax_gen.init(key, jnp.zeros((1, 8, 8, 8, 1)), train=False))
    jax_kernel = _np_tree(init(jax.random.key(2)))["params"]["up_0"]["ConvTranspose_0"]["kernel"]
    assert jax_kernel.shape == (3, 3, 3, 64, 32)
    assert abs(np.std(jax_kernel) / math.sqrt(1 / (64 * 27)) - 1) <= STD_TOL


def test_torch_default_init_is_not_flax_s():
    """What C7 was: torch's default ``kaiming_uniform(a=sqrt(5))`` has a
    third of lecun's variance and non-zero biases."""
    torch.manual_seed(3)
    conv = nn.Conv3d(16, 32, 3)
    s = math.sqrt(1 / flax_fan_in(conv))
    assert abs(conv.weight.std().item() / s - 1 / math.sqrt(3)) <= STD_TOL and conv.bias.abs().max() > 0
    init_like_flax(conv)
    assert abs(conv.weight.std().item() / s - 1) <= STD_TOL and not conv.bias.any()
