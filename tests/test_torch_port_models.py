"""Port models vs the JAX package, on the CPU: BatchNorm, the generator with
weights carried from JAX (``utils/weights.py``), parameter counts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrast_gan_3d_tpu.models.generator import ResnetGenerator as JaxGenerator
from contrast_gan_3d_tpu.models.norm import BatchNorm as JaxBatchNorm
from contrast_gan_3d_tpu.models.utils import generator_output_shape as jax_output_shape
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.models.norm import BatchNorm
from contrast_gan_3d_tpu_torch.models.utils import count_parameters, generator_output_shape
from contrast_gan_3d_tpu_torch.utils.weights import generator_state_dict_from_jax

TINY = dict(n_resnet_blocks=2, n_updownsample_blocks=1, init_channels_out=8)


def _np_tree(tree):
    return jax.tree.map(np.asarray, dict(tree))


def randomize_norms(variables, rng):
    """JAX init leaves BatchNorm at scale 1, bias 0, mean 0, var 1; give it
    non-trivial values so eval mode tests the carried statistics."""
    def fill(tree, key=None):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v, k)
            elif key == "BatchNorm_0" and k in ("scale", "var"):
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif key == "BatchNorm_0" and k in ("bias", "mean"):
                out[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    return fill(variables)


def carried_generator(cfg, seed, shape=(1, 16, 16, 16, 1), **kw):
    """(jax module, numpy variables, port module with the same weights)."""
    jgen = JaxGenerator(**cfg, **kw)
    variables = jgen.init(jax.random.key(seed), jnp.zeros(shape), train=False)
    variables = randomize_norms(_np_tree(variables), np.random.default_rng(seed))
    tgen = ResnetGenerator(**cfg, **kw)
    tgen.load_state_dict(generator_state_dict_from_jax(variables), strict=True)
    return jgen, variables, tgen


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_matches_jax(rng, train):
    x = rng.normal(1.0, 2.0, (2, 4, 5, 6, 3)).astype(np.float32)  # channels last
    params = {"scale": rng.uniform(0.5, 1.5, 3).astype(np.float32),
              "bias": rng.normal(size=3).astype(np.float32)}
    stats = {"mean": rng.normal(size=3).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, 3).astype(np.float32)}
    jbn = JaxBatchNorm(use_running_average=not train, momentum=0.9, epsilon=1e-5)
    jvars = {"params": params, "batch_stats": stats}
    if train:
        want, upd = jbn.apply(jvars, jnp.asarray(x), mutable=["batch_stats"])
    else:
        want, upd = jbn.apply(jvars, jnp.asarray(x)), {"batch_stats": stats}

    bn = BatchNorm(3)
    bn.load_state_dict({
        "weight": torch.from_numpy(params["scale"]), "bias": torch.from_numpy(params["bias"]),
        "running_mean": torch.from_numpy(stats["mean"]), "running_var": torch.from_numpy(stats["var"]),
    })
    bn.train(train)
    got = bn(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]), atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]), atol=1e-5)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("placement", ["same", "torch"])
@pytest.mark.parametrize("s2d_factor", [4, None])
def test_tiny_generator_matches_jax(train, placement, s2d_factor):
    jgen, variables, tgen = carried_generator(
        TINY, 3, tconv_placement=placement, s2d_factor=s2d_factor
    )
    x = np.random.default_rng(4).normal(0, 0.5, (2, 16, 16, 16, 1)).astype(np.float32)
    _check_forward(jgen, variables, tgen, x, train)


@pytest.mark.parametrize("train,placement", [(False, "same"), (True, "same"), (False, "torch")])
def test_default_generator_matches_jax(train, placement):
    jgen, variables, tgen = carried_generator({}, 5, tconv_placement=placement)
    x = np.random.default_rng(6).normal(0, 0.5, (2, 16, 16, 16, 1)).astype(np.float32)
    _check_forward(jgen, variables, tgen, x, train)


def _check_forward(jgen, variables, tgen, x, train):
    if train:
        want, upd = jgen.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = jgen.apply(variables, jnp.asarray(x), train=False)
    tgen.train(train)
    with torch.no_grad():
        got = tgen(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    if train:
        want_sd = generator_state_dict_from_jax(
            {"params": variables["params"], "batch_stats": _np_tree(upd["batch_stats"])}
        )
        got_sd = tgen.state_dict()
        for k, v in want_sd.items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(), atol=1e-5, err_msg=k)


def test_default_generator_parameter_count():
    assert count_parameters(ResnetGenerator()) == 1_035_297
    assert count_parameters(ResnetGenerator(s2d_factor=None)) == 1_035_297


def test_carried_state_dict_covers_every_tensor():
    """strict=True above already fails on a missing or unexpected key; here
    the carried kernels must also land in torch's layouts."""
    _, variables, tgen = carried_generator(TINY, 7)
    p = variables["params"]
    np.testing.assert_array_equal(
        tgen.first.conv.weight.detach().numpy(), p["first"]["Conv_0"]["kernel"].transpose(4, 3, 0, 1, 2)
    )
    np.testing.assert_array_equal(
        tgen.up_0.conv.weight.detach().numpy(),
        p["up_0"]["ConvTranspose_0"]["kernel"][::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2),
    )
    np.testing.assert_array_equal(
        tgen.resnet_1.block1.norm.running_var.numpy(),
        variables["batch_stats"]["resnet_1"]["ConvBlock_1"]["BatchNorm_0"]["var"],
    )


@pytest.mark.parametrize("dims,n", [((16, 16, 16), 2), ((20, 18, 17), 2), ((9, 5, 3), 1)])
def test_generator_output_shape_matches_jax(dims, n):
    assert generator_output_shape(dims, n) == jax_output_shape(dims, n)


@pytest.mark.parametrize("kw", [dict(layout="packed"), dict(ndim=2), dict(norm="layer"), dict(norm="instance")])
def test_unported_options_point_to_roadmap(kw):
    """All four raised until they were ported; they now build and match
    the JAX generator (the packed layout in depth:
    ``tests/test_torch_port_packed.py``; 2D: ``tests/test_torch_port_2d.py``;
    instance norm: ``tests/test_torch_port_options.py``)."""
    ndim = kw.get("ndim", 3)
    cfg = dict(TINY, **kw)
    jgen, variables, tgen = carried_generator(cfg, 8, shape=(1,) + (16,) * ndim + (1,))
    x = np.random.default_rng(9).normal(0, 0.5, (2,) + (16,) * ndim + (1,)).astype(np.float32)
    want = jgen.apply(variables, jnp.asarray(x), train=False)
    tgen.eval()
    with torch.no_grad():
        got = torch.movedim(tgen(torch.movedim(torch.from_numpy(x), -1, 1)), 1, -1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
