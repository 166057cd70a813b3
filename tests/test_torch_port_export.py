"""The port's correction artifacts (``contrast_gan_3d_tpu_torch/eval/
export.py``, the ``export_corrector`` command, ``serve --artifact``) on the
CPU: the counterparts of ``tests/test_export_artifact.py``. The generator
is ``tests/test_serving.py``'s (1 resnet block, 1 up/down, 2 channels, 16^3
patches, batch 8: one forward per export), its weights carried from JAX by
``utils/weights.py``, volumes from a numpy seed.

An artifact is the live corrector's own sequence of operators, traced: on
the CPU it equals the live corrector bit for bit, packed and direct (the
direct one through the B1/B3 operators' CPU implementations). On the card
``chip_smoke.py`` holds it against the live corrector and loads a
CPU-exported artifact onto the card.
"""

import copy
import json
from functools import partial

import numpy as np
import pytest
import torch

from contrast_gan_3d_tpu_torch import export_corrector, serve
from contrast_gan_3d_tpu_torch.eval.corrector import CCTAContrastCorrector
from contrast_gan_3d_tpu_torch.eval.export import (
    ARTIFACT_SUFFIX,
    ArtifactBundle,
    load_exported_corrector,
    save_exported_corrector,
)
from contrast_gan_3d_tpu_torch.models.discriminator import PatchGANDiscriminator
from contrast_gan_3d_tpu_torch.serving import correct_remote
from contrast_gan_3d_tpu_torch.trainer import checkpoint as ckpt_lib
from contrast_gan_3d_tpu_torch.trainer.optim import make_optimizer
from contrast_gan_3d_tpu_torch.trainer.trainer import Trainer
from tests.test_torch_port_models import carried_generator

SERVE_GEN = dict(n_resnet_blocks=1, n_updownsample_blocks=1, init_channels_out=2)
PATCH = (16, 16, 16)
SHAPE = (20, 20, 18)
KW = dict(inference_patch_size=PATCH, overlap=0.25, batch_size=8, device="cpu")
B3_OP = "contrast_gan_3d_torch.s2d_conv3d_block.default"
TIMEOUT = 60


def _vol(seed, shape=SHAPE):
    return np.random.default_rng(seed).integers(-1024, 1500, shape).astype(np.int16)


@pytest.fixture(scope="module")
def generator():
    return carried_generator(SERVE_GEN, 31)[2]


@pytest.fixture(scope="module")
def corrector(generator):
    corr = CCTAContrastCorrector(generator, **KW)
    assert corr.packed
    return corr


@pytest.fixture(scope="module")
def artifact(corrector, tmp_path_factory):
    return save_exported_corrector(tmp_path_factory.mktemp("art") / "art", corrector, SHAPE)


@pytest.fixture(scope="module")
def loaded(artifact):
    return load_exported_corrector(artifact, device="cpu")


def _ops(art) -> set:
    return {str(n.target) for n in art._module.graph.nodes if n.op == "call_function"}


@pytest.mark.parametrize("layout", ["packed", "direct"])
def test_export_round_trip_equals_the_live_corrector(generator, corrector, artifact, tmp_path, layout):
    """Save, load and call: bit-equal to the live corrector on the CPU; the
    sidecar states the contract; the direct artifact keeps B3 as its
    operator."""
    if layout == "direct":
        corrector = CCTAContrastCorrector(generator, **dict(KW, layout="direct"))
        artifact = save_exported_corrector(tmp_path / "direct.pt", corrector, SHAPE)
        assert artifact.name == "direct.pt" + ARTIFACT_SUFFIX
    assert artifact.name.endswith(ARTIFACT_SUFFIX)
    meta = json.loads(artifact.with_name(artifact.name + ".json").read_text())
    assert meta["volume_shape"] == meta["out_shape"] == list(SHAPE)
    assert (meta["in_dtype"], meta["out_dtype"], meta["platforms"]) == ("int16", "float32", ["cpu"])
    loaded = load_exported_corrector(artifact, device="cpu")
    assert (B3_OP in _ops(loaded)) == (layout == "direct")
    vol = _vol(1)
    got = loaded(vol)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, corrector(vol), rtol=0, atol=0)


def test_load_without_suffix_and_without_sidecar(artifact, loaded, tmp_path):
    bare = load_exported_corrector(artifact.with_name(artifact.name.removesuffix(ARTIFACT_SUFFIX)), device="cpu")
    lone = tmp_path / artifact.name
    lone.write_bytes(artifact.read_bytes())  # no sidecar beside it
    alone = load_exported_corrector(lone, device="cpu")
    assert alone.volume_shape == SHAPE and alone.in_dtype == torch.int16 and alone.platforms == ("cpu",)
    vol = _vol(2)
    want = loaded(vol)
    torch.testing.assert_close(alone(vol), want, rtol=0, atol=0)
    torch.testing.assert_close(bare(vol), want, rtol=0, atol=0)


def test_shape_contract_enforced(loaded):
    with pytest.raises(ValueError, match="exported for volume shape"):
        loaded(np.zeros((8, 8, 8), np.int16))


def test_dtype_coerced_and_float_input_saturates(loaded):
    """A float volume is rounded and clipped into the int16 contract: the
    same values give the int16 result, and 40000.0 gives 32767's, not a
    wrapped value's."""
    vol = _vol(3)
    torch.testing.assert_close(loaded(vol.astype(np.float32)), loaded(vol), rtol=0, atol=0)
    hot = loaded(np.full(SHAPE, 40000.0, np.float32))
    torch.testing.assert_close(hot, loaded(np.full(SHAPE, 32767, np.int16)), rtol=0, atol=0)
    assert not torch.equal(hot, loaded(np.full(SHAPE, np.float32(40000.0)).astype(np.int16)))


def test_float_input_contract(corrector, tmp_path):
    loaded = load_exported_corrector(save_exported_corrector(tmp_path / "f", corrector, SHAPE,
                                                             in_dtype=torch.float32), device="cpu")
    vol = np.random.default_rng(4).normal(0, 300, SHAPE).astype(np.float32)
    assert loaded.in_dtype == torch.float32
    torch.testing.assert_close(loaded(vol), corrector(vol), rtol=0, atol=0)


def test_export_2d_round_trip(tmp_path):
    _, _, gen2d = carried_generator(SERVE_GEN, 32, shape=(1, 16, 16, 1), ndim=2)
    corr = CCTAContrastCorrector(gen2d, inference_patch_size=(16, 16), batch_size=4, device="cpu")
    vol = _vol(5, (16, 16, 6))
    loaded = load_exported_corrector(save_exported_corrector(tmp_path / "c2d", corr, vol.shape), device="cpu")
    torch.testing.assert_close(loaded(vol), corr(vol), rtol=0, atol=0)


def test_serve_artifact_round_trip(artifact, corrector):
    """``serve <file> --artifact``: the daemon warms the artifact's shape
    and serves it; replies equal the live corrector's."""
    argv = [str(artifact), "--artifact", "--device", "cpu", "--port", "0", "--host", "127.0.0.1"]
    srv = serve.build_server(serve.parse_args(argv))
    srv.start()
    try:
        host, port = srv.address
        vol = _vol(6)
        np.testing.assert_array_equal(correct_remote(f"http://{host}:{port}", vol, timeout=TIMEOUT),
                                      corrector(vol).numpy())
    finally:
        srv.stop(drain_timeout=TIMEOUT)


@pytest.fixture(scope="module")
def bundle_dir(generator, tmp_path_factory):
    """``export_corrector <run dir> <dir> --shape 20 20 16 --shape 20 20 24``
    on the CPU from a port checkpoint of ``generator``."""
    tmp = tmp_path_factory.mktemp("bundle")
    tx = partial(make_optimizer, "adam", lr=1e-3)
    trainer = Trainer(copy.deepcopy(generator), PatchGANDiscriminator(init_channels_out=2, discriminator_depth=1),
                      tx, tx, device="cpu")
    ckpt_lib.save_checkpoint(trainer.state, tmp / "run", meta=trainer._ckpt_meta)
    written = export_corrector.main([str(tmp / "run"), str(tmp / "bundle"), "--shape", "20", "20", "16", "--shape",
                                     "20", "20", "24", "--patch", "16", "16", "16", "--batch", "8", "--dtype",
                                     "float32", "--device", "cpu"])
    assert [p.name for p in written] == [f"corrector_20x20x{d}{ARTIFACT_SUFFIX}" for d in (16, 24)]
    meta = json.loads(written[0].with_name(written[0].name + ".json").read_text())
    assert (meta["patch_size"], meta["overlap"], meta["compute_dtype"]) == ([16, 16, 16], 0.25, "float32")
    return tmp / "bundle"


@pytest.fixture(scope="module")
def bundle_server(bundle_dir):
    """``serve <bundle dir> --artifact`` on the CPU, started."""
    argv = [str(bundle_dir), "--artifact", "--device", "cpu", "--port", "0", "--host", "127.0.0.1"]
    srv = serve.build_server(serve.parse_args(argv))
    srv.start()
    yield srv
    srv.stop(drain_timeout=TIMEOUT)


def test_artifact_bundle_picks_pads_crops(generator, bundle_server):
    """The bundle (loaded by ``serve --artifact`` with ``ArtifactBundle.
    from_dir``) picks the smallest exported depth that holds the volume,
    edge-pads z to it and crops back: the live corrector with
    ``z_bucket=8``, bit for bit."""
    bundle = bundle_server.service.corrector
    assert isinstance(bundle, ArtifactBundle)
    assert [a.volume_shape for a in bundle.artifacts] == [(20, 20, 16), (20, 20, 24)]
    assert bundle.pick((20, 20, 16)).volume_shape == (20, 20, 16)
    assert bundle.pick((20, 20, 17)).volume_shape == (20, 20, 24)
    bucketed = CCTAContrastCorrector(generator, z_bucket=8, **KW)
    for d in (16, 20):
        vol = _vol(d, (20, 20, d))
        torch.testing.assert_close(bundle(vol), bucketed(vol), rtol=0, atol=0)
    with pytest.raises(ValueError, match="no artifact serves"):
        bundle(np.zeros((20, 20, 30), np.int16))
    with pytest.raises(ValueError, match="no artifact serves"):
        bundle(np.zeros((24, 24, 16), np.int16))
    with pytest.raises(ValueError, match="empty artifact bundle"):
        ArtifactBundle([])


def test_export_cli_bundle_served_by_serve_artifact(generator, bundle_server):
    """``serve <bundle dir> --artifact`` serves what ``export_corrector``
    wrote, equal to the live corrector on the padded depth."""
    host, port = bundle_server.address
    vol = _vol(7, (20, 20, 21))
    want = CCTAContrastCorrector(generator, z_bucket=8, **KW)(vol).numpy()
    np.testing.assert_array_equal(correct_remote(f"http://{host}:{port}", vol, timeout=TIMEOUT), want)
    assert bundle_server.service.device_info() == {"platform": "cpu", "device": "cpu"}
