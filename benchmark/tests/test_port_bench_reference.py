"""The plain reference against the port, on the CPU at small sizes, through
the benchmark's own loops: one training cycle pattern for both
configurations (three cycles: the eager one and two more) and a 3D and a 2D
correction, all in float32, where the two must agree to rounding.

Tolerances: the first moments' relative leaf-norm gaps 1e-4 (float32
rounding, reordered sums; measured about 1e-5); the well-conditioned
losses' of all three cycles 1e-4 (measured 4.5e-5); the leaves' changes over three
cycles 0.05, since Adam's normalised steps amplify a rounding-sized
gradient difference wherever a component's moment nearly cancels between
steps (measured 1.1e-2 on a 64-element norm scale); a corrected voxel may
differ by 0.05 HU (float32 attenuation rounding, about 1e-5 of the
scaler's 600 HU factor, measured 0.011 HU at these sizes)."""

import pytest

from benchmark import checks, counts
from benchmark.reference import model
from benchmark.tests import small


@pytest.mark.parametrize("cell", ["train.basic_3d", "train.conf_2d"])
def test_train_cycles_match_reference(cell):
    result, outcome = small.run(cell)
    tolerance = {"loss_gap": 1e-4, "grad_gap": 1e-4, "grad_diff_median": 1e-3, "change_gap": 0.05}
    assert set(result["checks"]) == set(tolerance)
    for name, check in result["checks"].items():
        assert check["value"] <= tolerance[name], (name, check, outcome.notes)
    assert result["correct"] is True
    assert outcome.attempted >= 1


@pytest.mark.parametrize("cell", ["correct.basic_3d.z400", "correct.conf_2d.z400"])
def test_correction_matches_reference(cell):
    result, outcome = small.run(cell)
    assert result["checks"]["hu_gap"]["value"] <= 0.05, (result["checks"], outcome.notes)
    assert outcome.attempted >= 1


@pytest.mark.parametrize("name,generator,critic", [("basic_3d", 1_035_297, 176_873), ("conf_2d", None, None)])
def test_reference_parameters_are_the_ports(name, generator, critic):
    """The reference's parameter set is the port's, name by name and shape
    by shape, and has the published counts."""
    from contrast_gan_3d_tpu_torch.models.discriminator import PatchGANDiscriminator
    from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator

    cfg = small.specs.config(small.specs.load_spec(), name)
    g, c = cfg["generator"], cfg["critic"]
    ndim = len(cfg["train"]["patch"])
    g_spec = model.generator_spec(g["n_resnet_blocks"], g["n_updownsample_blocks"], g["init_channels_out"], ndim)
    c_spec = model.critic_spec(c["init_channels_out"], c["discriminator_depth"], ndim, c["norm"])
    port_g = ResnetGenerator(n_resnet_blocks=g["n_resnet_blocks"], n_updownsample_blocks=g["n_updownsample_blocks"],
                             init_channels_out=g["init_channels_out"], ndim=ndim)
    port_c = PatchGANDiscriminator(init_channels_out=c["init_channels_out"],
                                   discriminator_depth=c["discriminator_depth"], ndim=ndim)
    for spec_, port in ((g_spec, port_g), (c_spec, port_c)):
        assert {n: s for n, s, _ in spec_} == {n: tuple(p.shape) for n, p in port.named_parameters()}
    if generator is not None:
        assert sum(p.numel() for p in port_g.parameters()) == generator == g.get("parameters")
        assert sum(p.numel() for p in port_c.parameters()) == critic == c.get("parameters")


def test_control_precisions_round_as_named():
    import torch

    x = torch.tensor([1.0 + 2**-12, 1.0 + 2**-10 + 2**-11, 300.0, 1e-3])
    assert model.round_to(x, "tf32")[0] == 1.0  # below half a 10-bit ulp
    assert model.round_to(x, "tf32")[1] == 1.0 + 2**-9  # a tie rounds to even
    assert model.round_to(x, "bf16")[2] == 300.0
    # fp8 scales each tensor by its largest magnitude: 300 -> 448 exactly
    assert model.round_to(x, "fp8")[2] == 300.0
    y = torch.tensor([1.0, 0.9, 1e-3])
    assert torch.allclose(model.round_to(y, "fp8"), torch.tensor([1.0, 0.875, 1e-3]), rtol=0.07)
    assert model.round_to(x, None) is x
    # the backward pass rounds the gradient, the forward pass leaves the value
    g = torch.tensor([1.0, 1.0 + 2**-12], requires_grad=True)
    model.round_grad(g, "tf32").backward(torch.tensor([1.0 + 2**-12, 3.0]))
    assert g.grad.tolist() == [1.0, 3.0]


def test_train_checks_read_one_when_the_state_stays():
    """A run that leaves its parameters unchanged reads 1 on the change
    gap by the measure alone."""
    import torch

    init = {"generator": {"a": torch.ones(3), "b": torch.ones(2)}, "critic": {"c": torch.ones(2)}}
    moments = {net: {k: torch.full_like(v, 0.5) for k, v in leaves.items()} for net, leaves in init.items()}
    ref = {"losses": [{k: 1.0 for k in checks.WELL_CONDITIONED}] * 2, "moments": [moments] * 2,
           "generator": {k: v + 1 for k, v in init["generator"].items()},
           "critic": {k: v + 1 for k, v in init["critic"].items()}}
    port = {**ref, "generator": init["generator"], "critic": init["critic"]}
    assert checks.train_checks(port, ref, init)["change_gap"][0] == pytest.approx(1.0)
    assert checks.train_checks(ref, ref, init)["change_gap"][0] == 0.0


def test_generator_count_by_hand():
    """125.76 GFLOP for one 128^3 forward of basic_3d's generator."""
    cfg = small.specs.config(small.specs.load_spec(), "basic_3d")
    convs = counts.generator_convs(cfg["generator"], (128, 128, 128))
    v = 128**3
    by_hand = (2 * 16 * 343 * v * 2                  # the 7^3 stem and projection
               + 2 * 32 * 16 * 27 * v // 8 * 2       # down_0 and up_0
               + 2 * 64 * 32 * 27 * v // 64 * 2      # down_1 and up_1
               + 8 * 2 * 64 * 64 * 27 * v // 64)     # the residual blocks' convs
    assert sum(c.flops(1) for c in convs) == by_hand
