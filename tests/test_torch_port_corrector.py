"""The port's serving slice as a whole, on the CPU: the sliding-window
corrector vs the JAX corrector with the same carried weights, the window
helpers, the device rule, and the port's isolation from JAX."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from contrast_gan_3d_tpu.eval.corrector import CCTAContrastCorrector as JaxCorrector
from contrast_gan_3d_tpu.ops import sliding_window as jax_sw
from contrast_gan_3d_tpu_torch.eval.corrector import CCTAContrastCorrector
from contrast_gan_3d_tpu_torch.ops import sliding_window as port_sw
from tests.test_torch_port_models import TINY, carried_generator

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def carried():
    return carried_generator(TINY, 11)


@pytest.mark.parametrize("overlap,batch_size", [(0.25, 3), (0.5, 3), (0.5, 8)])
def test_corrector_matches_jax(carried, overlap, batch_size):
    """(20,18,16) int16 volume, 16^3 patches: 4 patches at either overlap,
    so batch 3 leaves a remainder batch. Tolerance 0.1 HU = 1e-4 tanh
    units x 600."""
    jgen, variables, tgen = carried
    vol = np.random.default_rng(16).integers(-1024, 1500, (20, 18, 16)).astype(np.int16)
    jcorr = JaxCorrector(
        jgen, variables["params"], variables["batch_stats"], inference_patch_size=(16, 16, 16),
        overlap=overlap, batch_size=batch_size, layout="direct",
    )
    want = np.asarray(jcorr(vol))
    corr = CCTAContrastCorrector(
        tgen, inference_patch_size=(16, 16, 16), overlap=overlap, batch_size=batch_size, layout="direct",
        device="cpu"
    )
    got = corr(vol)
    assert got.dtype == torch.float32 and tuple(got.shape) == vol.shape
    np.testing.assert_allclose(got.numpy(), want, atol=0.1)


def test_corrector_pads_small_volumes(carried):
    """x and z smaller than the 16^3 patch: centered edge padding, cropped back."""
    jgen, variables, tgen = carried
    vol = np.random.default_rng(17).integers(-1024, 1500, (12, 18, 10)).astype(np.int16)
    want = np.asarray(JaxCorrector(
        jgen, variables["params"], variables["batch_stats"], inference_patch_size=(16, 16, 16),
        batch_size=2, layout="direct",
    )(vol))
    corr = CCTAContrastCorrector(tgen, inference_patch_size=(16, 16, 16), batch_size=2, layout="direct",
                                 device="cpu")
    got = corr(vol)
    assert tuple(got.shape) == vol.shape
    np.testing.assert_allclose(got.numpy(), want, atol=0.1)


def test_zero_generator_is_identity():
    vol = np.random.default_rng(18).integers(-1024, 1500, (10, 9, 8)).astype(np.int16)
    correct = port_sw.make_volume_corrector(
        lambda x: torch.zeros_like(x), patch_size=(8, 8, 8), overlap=0.5, device="cpu"
    )
    np.testing.assert_allclose(correct(vol).numpy(), vol.astype(np.float32), atol=1e-3)


@pytest.mark.parametrize(
    "shape,patch,overlap", [((20, 18, 16), (16, 16, 16), 0.25), ((512, 512, 128), (128,) * 3, 0.25),
                            ((512, 512, 400), (128,) * 3, 0.5), ((9, 40, 7), (8, 16, 8), 0.5)],
)
def test_window_helpers_match_jax(shape, patch, overlap):
    assert port_sw.plan_stride(patch, overlap, False) == jax_sw.plan_stride(patch, overlap, False)
    _, stride = port_sw.plan_stride(patch, overlap, False)
    padded = tuple(max(s, p) for s, p in zip(shape, patch))
    np.testing.assert_array_equal(
        port_sw._plan_grid(padded, patch, stride), jax_sw._plan_grid(padded, patch, stride)
    )
    for a, b in zip(port_sw.weight_vectors(padded, patch, stride, 0.125),
                    jax_sw.weight_vectors(padded, patch, stride, 0.125)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port_sw.gaussian_weights(patch), jax_sw.gaussian_weights(patch))
    for packed in (False, True):
        assert port_sw.num_patches(shape, patch, overlap, packed) == jax_sw.num_patches(
            shape, patch, overlap, packed
        )


def test_main_path_patch_counts():
    """The grids chip_smoke.py and PERF.md count launches on: 25 patches per
    512x512x128 volume at 25% overlap, 4 for the 96x96x64 parity volume."""
    assert port_sw.num_patches((512, 512, 128), (128,) * 3, 0.25) == 25
    assert port_sw.num_patches((96, 96, 64), (64,) * 3, 0.25) == 4
    assert port_sw.num_patches((512, 512, 400), (128,) * 3, 0.5) == 7 * 7 * 6


def test_corrector_defaults_to_cuda_and_raises_without_it(carried):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the rule under test is its absence")
    with pytest.raises(RuntimeError, match="cuda"):
        CCTAContrastCorrector(carried[2], inference_patch_size=(16, 16, 16))
    with pytest.raises(RuntimeError, match="cuda"):
        port_sw.make_volume_corrector(lambda x: x)


@pytest.mark.parametrize("kw", [dict(layout="packed"), dict(inference_patch_size=(16, 16))])
def test_corrector_unported_options_point_to_roadmap(carried, kw):
    """Both raised until they were ported. ``layout="packed"`` now selects
    the packed sliding window, batch 24 as in JAX (parity in
    ``tests/test_torch_port_packed_serving.py``), and refuses a window it
    cannot run. A 2-element patch size (the 2D corrector) selects the slice
    corrector, batch 8 on the CPU as in JAX (parity in
    ``tests/test_torch_port_2d.py``)."""
    if "layout" in kw:
        corrector = CCTAContrastCorrector(carried[2], inference_patch_size=(16, 16, 16), device="cpu", **kw)
        assert corrector.packed and corrector.batch_size == 24
        with pytest.raises(ValueError, match="unsupported"):
            CCTAContrastCorrector(carried[2], inference_patch_size=(16, 16, 16), overlap=0.8, device="cpu", **kw)
        return
    corrector = CCTAContrastCorrector(carried[2], device="cpu", **kw)
    assert corrector.is_2d and corrector.batch_size == 8


# packages the port must not need when a module is imported (the card's
# machine lacks most of them; the figures and loggers import theirs at use)
ABSENT_ON_THE_CARD = ("pandas", "sklearn", "h5py", "matplotlib", "wandb", "tensorboardX", "msgpack", "orbax",
                      "seaborn", "tensorboard")


def test_port_imports_nothing_of_jax():
    """Every port module and chip_smoke.py import without JAX, the JAX
    package or a package the card's machine lacks entering the process."""
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in (REPO / "contrast_gan_3d_tpu_torch").rglob("*.py")
    )
    # the offline preprocessing and the learning check's modules and CLIs
    assert {f"contrast_gan_3d_tpu_torch.{m}" for m in (
        "preprocess", "eval_hu_shift", "validate_learning", "data.preprocess", "data.labeling",
        "eval.hu_distribution_shift", "utils.geometry", "ops.resample",
        # meshes, the memory and debug tools
        "parallel.mesh", "parallel.multihost", "parallel.inference", "utils.memory", "utils.debug",
        "memory_report",
        # the study tools: labels and folds, marker recall, overlap, FLOPs
        "create_dataset", "synthetic_tracker", "eval_marker_recall", "eval.marker_recall_rate",
        "eval_overlap_quality", "flops_accounting",
        # JAX checkpoints read without msgpack, and their import
        "utils.msgpack", "import_jax_checkpoint",
        # the figures, the batch viewer and its command (matplotlib at first use)
        "utils.visualization", "utils.batch_viewer", "view_batches")} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "banned = ('jax', 'jaxlib', 'flax', 'contrast_gan_3d_tpu') + " + repr(ABSENT_ON_THE_CARD) + "\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in banned)\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.startswith("ok"), res.stdout + res.stderr
