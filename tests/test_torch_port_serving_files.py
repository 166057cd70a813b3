"""The port's serving from checkpoints and files vs the JAX package, on the
CPU: ``derive_generator_arch``, the image readers and writers,
``CCTAContrastCorrector.from_checkpoint`` / ``correct_file``, the cohort
function ``eval/utils.correct_patients`` and the ``correct_scans`` command.

Tolerances, and why:
- ``derive_generator_arch``, the readers and the writers: exact (the same
  arithmetic); written files byte for byte (.mhd, .raw, .nii), .nii.gz after
  decompression (gzip's header holds an mtime);
- ``from_checkpoint`` over a port checkpoint: its generator's state and its
  corrections equal the trained generator's exactly;
- port vs JAX ``correct_file`` with the same weights: the int16 files within
  1 HU with at least 99.9% of voxels equal (the f32 corrections differ by
  at most 0.1 HU, which can move a value across a rounding boundary);
- the overlapped cohort against the sequential one: byte for byte; each
  written volume against ``device_int16(corrector(scan))``: exactly.
"""

import gzip
import importlib
import json
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrast_gan_3d_tpu import config as jax_paths
from contrast_gan_3d_tpu.eval.corrector import CCTAContrastCorrector as JaxCorrector
from contrast_gan_3d_tpu.eval.utils import device_int16 as jax_device_int16
from contrast_gan_3d_tpu.eval.utils import load_patient_or_scan as jax_load_patient_or_scan
from contrast_gan_3d_tpu.models.generator import ResnetGenerator as JaxGenerator
from contrast_gan_3d_tpu.models.utils import conv_output_shape as jax_conv_output_shape
from contrast_gan_3d_tpu.models.utils import derive_generator_arch as jax_derive_generator_arch
from contrast_gan_3d_tpu.utils import io_utils as jio
from contrast_gan_3d_tpu_torch import config as paths
from contrast_gan_3d_tpu_torch import correct_scans
from contrast_gan_3d_tpu_torch.data.preprocess import write_patient
from contrast_gan_3d_tpu_torch.eval.corrector import CCTAContrastCorrector
from contrast_gan_3d_tpu_torch.eval.utils import (
    correct_patient,
    correct_patients,
    device_int16,
    load_patient_or_scan,
    parallel_correct_patients,
)
from contrast_gan_3d_tpu_torch.models.discriminator import PatchGANDiscriminator
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.models.utils import (
    conv_output_shape,
    count_parameters,
    derive_generator_arch,
    parameter_overview,
)
from contrast_gan_3d_tpu_torch.trainer import checkpoint as ckpt_lib
from contrast_gan_3d_tpu_torch.trainer.optim import make_optimizer
from contrast_gan_3d_tpu_torch.trainer.trainer import Trainer
from contrast_gan_3d_tpu_torch.utils import io_utils as pio
from contrast_gan_3d_tpu_torch.utils.weights import generator_state_dict_from_jax
from tests.test_io_goldens import write_nifti_spec
from tests.test_torch_port_fit import CRITIC, GEN, fold, tiny_loaders, tiny_trainer  # noqa: F401  (fold: fixture)
from tests.test_torch_port_models import TINY, carried_generator

PATCH = (16, 16, 16)
SCAN = (24, 20, 16)
ROT20 = np.array([[np.cos(0.35), -np.sin(0.35), 0.0], [np.sin(0.35), np.cos(0.35), 0.0], [0.0, 0.0, 1.0]])


# --- models/utils -------------------------------------------------------------


@pytest.mark.parametrize("arch", [
    dict(),  # the default 1,035,297-parameter generator
    dict(n_resnet_blocks=1, n_updownsample_blocks=1, init_channels_out=4),
    dict(n_resnet_blocks=2, n_updownsample_blocks=3, init_channels_out=8),
    dict(n_resnet_blocks=6, n_updownsample_blocks=2, init_channels_out=8, tconv_placement="torch"),
])
def test_derive_generator_arch_matches_jax(arch):
    """On a state_dict carried from the JAX variables, the same dict as JAX
    on the flax tree, and the derived port generator loads it strictly."""
    jgen = JaxGenerator(**arch)
    shapes = jax.eval_shape(partial(jgen.init, train=False), jax.random.key(0), jnp.zeros((1, 16, 16, 16, 1)))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    state = generator_state_dict_from_jax(variables)
    got = derive_generator_arch(state)
    assert got == jax_derive_generator_arch(variables["params"])
    ResnetGenerator(**got, tconv_placement=arch.get("tconv_placement", "same")).load_state_dict(state, strict=True)
    with pytest.raises(ValueError):
        derive_generator_arch({k: v for k, v in state.items() if not k.startswith("first.")})


def test_model_helpers_match_jax():
    for args in [((16, 17, 9), 3, 1, 2), ((16, 17, 9), 7, 3, 1), ((8, 5, 4), 3, 1, 2, 1, 1)]:
        assert conv_output_shape(*args) == jax_conv_output_shape(*args)
    gen = ResnetGenerator(**TINY)
    lines = parameter_overview(gen, prefix="G/").splitlines()
    assert len(lines) == len(list(gen.parameters())) and lines[0].startswith("G/first.conv.weight")
    assert sum(int(line.split()[-1]) for line in lines) == count_parameters(gen)


# --- utils/io_utils -------------------------------------------------------------


def _volume(rng, dtype=np.int16, shape=SCAN):
    return rng.integers(-1024, 1500, shape).astype(dtype)


def _reader_case(name, rng, tmp_path) -> Path:
    """A scan file in one of the layouts the readers must handle."""
    vol = _volume(rng)
    geo = dict(spacing=(0.4, 0.5, 0.625), origin=(-12.5, 30.25, 101.0))
    if name == "lps_mhd":
        jio.write_mhd(vol, tmp_path / "a.mhd", **geo)
    elif name == "ras_mhd":  # not LPS: the reader flips x and y
        jio.write_mhd(vol, tmp_path / "a.mhd", direction=np.diag([-1.0, -1.0, 1.0]), **geo)
    elif name == "permuted_mhd":  # image axes along (z, x, y) of the world, one flipped
        jio.write_mhd(vol, tmp_path / "a.mhd", direction=np.array([[0, 1.0, 0], [0, 0, -1.0], [1.0, 0, 0]]), **geo)
    elif name == "oblique_mhd":
        jio.write_mhd(vol, tmp_path / "a.mhd", direction=ROT20 @ np.diag([-1.0, 1, -1]), **geo)
    elif name == "mha":
        jio.write_mhd(vol, tmp_path / "a.mha", **geo)
    elif name == "unsigned_mhd":  # MET_USHORT stored at +32768: shifted down before the clip
        jio.write_mhd((vol.astype(np.int32) + 32768).astype(np.uint16), tmp_path / "a.mhd", **geo)
    elif name == "oblique_nii_gz":
        jio.write_nifti(vol, tmp_path / "a.nii.gz", direction=ROT20, **geo)
    elif name == "nii_sform_and_qform":  # the sform wins
        srow = np.array([[-0.4, 0, 0, 5.0], [0, 0.5, 0, -6.0], [0, 0, 0.625, 7.0]])
        write_nifti_spec(tmp_path / "a.nii", vol, srow=srow, quatern=(0.0, 0.0, np.sin(np.pi / 4), 1, 2, 3, 1.0))
    elif name == "nii_qform":
        write_nifti_spec(tmp_path / "a.nii", vol, pixdim=(0.4, 0.5, 0.625),
                         quatern=(0.0, 0.0, np.sin(np.pi / 4), 1.0, 2.0, 3.0, -1.0))
    return next(p for p in tmp_path.iterdir() if p.suffix in (".mhd", ".mha", ".nii", ".gz"))


@pytest.mark.parametrize("name", ["lps_mhd", "ras_mhd", "permuted_mhd", "oblique_mhd", "mha", "unsigned_mhd",
                                  "oblique_nii_gz", "nii_sform_and_qform", "nii_qform"])
def test_load_scan_equals_jax(rng, tmp_path, name):
    path = _reader_case(name, rng, tmp_path)
    (got, gmeta), (want, wmeta) = pio.load_scan(path), jio.load_scan(path)
    assert got.dtype == want.dtype == np.int16 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert set(gmeta) == set(wmeta)
    for k, v in wmeta.items():
        np.testing.assert_array_equal(gmeta[k], v)
    for k, v in jio.read_image_meta(path).items():
        np.testing.assert_array_equal(pio.read_image_meta(path)[k], v)
    assert pio.get_scan_orientation(path) == jio.get_scan_orientation(path)
    if name == "unsigned_mhd":
        assert got.min() >= -1024 and got.max() <= 1500 and got.min() < 0


@pytest.mark.parametrize("suffix", [".mhd", ".mha", ".nii", ".nii.gz"])
def test_save_scan_writes_what_jax_writes(rng, tmp_path, suffix):
    """Byte for byte (``.nii.gz`` after decompression), an oblique frame and
    a DICOM-UID-like name included."""
    vol = _volume(rng)
    meta = dict(offset=np.array([-12.5, 30.25, 101.0]), spacing=np.array([0.4, 0.5, 0.625]),
                direction=ROT20)
    name = "1.2.840.113" + suffix
    for pkg, sub in ((jio, "jax"), (pio, "port")):
        (tmp_path / sub).mkdir()
        pkg.save_scan(vol, meta["offset"], meta["spacing"], tmp_path / sub / name, direction=meta["direction"])
    jax_files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == jax_files
    for f in jax_files:
        a, b = (tmp_path / "port" / f).read_bytes(), (tmp_path / "jax" / f).read_bytes()
        if f.endswith(".gz"):
            a, b = gzip.decompress(a), gzip.decompress(b)
        assert a == b, f
    got, gmeta = pio.load_scan(tmp_path / "port" / name)
    np.testing.assert_array_equal(got, jio.load_scan(tmp_path / "jax" / name)[0])


def test_hdf5_raises_pointing_at_the_roadmap(rng, tmp_path):
    """HDF5 scans raised until HDF5 was ported: a raw HDF5 scan the JAX
    package wrote loads as JAX loads it (``load_scan``, the header-only
    ``read_image_meta``, ``load_patient_or_scan``); the port's ``save_scan``
    writes the file JAX's would (read back equal by JAX), and a missing
    corpus member raises the ``KeyError`` listing the members there are."""
    vol = _volume(rng)
    geo = dict(spacing=np.array([0.4, 0.5, 0.625]), origin=np.array([-12.5, 30.25, 101.0]))
    jio.write_hdf5_image(vol, tmp_path / "a.h5", **geo)
    jio.write_hdf5_image(vol, tmp_path / "a.hdf5", **geo)
    got, want = pio.load_scan(tmp_path / "a.h5"), jio.load_scan(tmp_path / "a.h5")
    np.testing.assert_array_equal(got[0], want[0])
    for k in ("spacing", "offset", "direction"):
        np.testing.assert_array_equal(got[1][k], want[1][k])
    meta, jmeta = pio.read_image_meta(tmp_path / "a.hdf5"), jio.read_image_meta(tmp_path / "a.hdf5")
    assert meta["shape"] == jmeta["shape"] == SCAN
    np.testing.assert_array_equal(meta["spacing"], jmeta["spacing"])
    np.testing.assert_array_equal(load_patient_or_scan(tmp_path / "a.h5")[0],
                                  jax_load_patient_or_scan(tmp_path / "a.h5")[0])
    pio.save_scan(vol, geo["origin"], geo["spacing"], tmp_path / "port.h5")
    jio.save_scan(vol, geo["origin"], geo["spacing"], tmp_path / "jax.h5")
    np.testing.assert_array_equal(jio.load_scan(tmp_path / "port.h5")[0], jio.load_scan(tmp_path / "jax.h5")[0])
    write_patient(vol, vol > 0, {"spacing": geo["spacing"], "offset": geo["origin"]}, "present", tmp_path / "c.h5")
    with pytest.raises(KeyError, match="present"):
        load_patient_or_scan(f"{tmp_path / 'c.h5'}::absent")


def test_path_helpers_match_jax():
    for p in ("a/1.2.840.113.mhd", "x.nii.gz", "c.h5::member", "plain", "p.npy"):
        assert pio.stem(p) == jio.stem(p)
        for s in (".mhd", ".nii.gz"):
            assert pio.with_image_suffix(p, s) == jio.with_image_suffix(p, s)


# --- the corrector from checkpoints and files --------------------------------


def _vol_from(rng, shape=SCAN):
    return rng.integers(-1024, 1500, shape).astype(np.int16)


def test_from_checkpoint_equals_the_trained_generator(fold, tmp_path, rng):  # noqa: F811
    """A tiny port fit writes <step>.pt; the corrector built from it holds
    the trainer's generator tensor for tensor and corrects as it does."""
    run = tmp_path / "run"
    trainer = tiny_trainer(ckpt_dir=run, iterations=4)
    loaders = tiny_loaders(fold)
    trainer.fit(loaders)
    for loader in loaders.values():
        loader.stop()
    ckpt_lib.flush_async_saves(run)
    assert json.loads((run / "4.meta.json").read_text()) == {"generator": {"tconv_placement": "same",
                                                                           "norm": "batch"}}
    kw = dict(inference_patch_size=PATCH, batch_size=2, device="cpu")
    corr = CCTAContrastCorrector.from_checkpoint(run, **kw)
    trained = trainer.state.generator.state_dict()
    assert list(corr.generator.state_dict()) == list(trained)
    for k, v in corr.generator.state_dict().items():
        assert torch.equal(v, trained[k]), k
    gen = ResnetGenerator(**GEN)
    gen.load_state_dict(trained, strict=True)
    vol = _vol_from(rng)
    torch.testing.assert_close(corr(vol), CCTAContrastCorrector(gen, **kw)(vol), rtol=0, atol=0)
    # an earlier checkpoint by its step, and the file itself
    first = min(int(p.stem) for p in run.glob("*.pt"))
    assert first < 4
    early = CCTAContrastCorrector.from_checkpoint(run, iteration=first, **kw)
    by_file = CCTAContrastCorrector.from_checkpoint(run / f"{first}.pt", **kw)
    for a, b in zip(early.generator.state_dict().values(), by_file.generator.state_dict().values()):
        assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError):
        CCTAContrastCorrector.from_checkpoint(tmp_path / "empty", **kw)


def _port_checkpoint(generator, ckpt_dir) -> Path:
    """A port ``<step>.pt`` (and meta sidecar) holding ``generator``."""
    tx = partial(make_optimizer, "adam", lr=1e-3)
    trainer = Trainer(generator, PatchGANDiscriminator(**CRITIC), tx, tx, device="cpu")
    return ckpt_lib.save_checkpoint(trainer.state, ckpt_dir, meta=trainer._ckpt_meta)


def test_from_checkpoint_takes_the_meta_sidecar(tmp_path, rng):
    """The torch transpose-conv placement cannot be read from the weights:
    it comes from the sidecar; an explicit generator wins."""
    torch.manual_seed(3)
    gen = ResnetGenerator(**GEN, tconv_placement="torch")
    _port_checkpoint(gen, tmp_path)
    kw = dict(inference_patch_size=PATCH, batch_size=2, device="cpu")
    corr = CCTAContrastCorrector.from_checkpoint(tmp_path, **kw)
    assert corr.generator.tconv_placement == "torch" and corr.generator.norm == "batch"
    vol = _vol_from(rng)
    want = CCTAContrastCorrector(gen, **kw)(vol)
    torch.testing.assert_close(corr(vol), want, rtol=0, atol=0)
    explicit = ResnetGenerator(**GEN)
    corr = CCTAContrastCorrector.from_checkpoint(tmp_path, generator=explicit, **kw)
    assert corr.generator is explicit and explicit.tconv_placement == "same"
    assert not torch.equal(corr(vol), want)


@pytest.fixture(scope="module")
def carried():
    return carried_generator(TINY, 21)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_correct_file_matches_jax(carried, tmp_path, rng, dtype):
    """JAX weights carried into a port checkpoint; one oblique .mhd scan
    corrected by JAX's ``correct_file`` and the port's. With ``dtype``
    bf16 the patches are rounded to bf16 and the f32 generator computes in
    f32 on both sides."""
    jgen, variables, tgen = carried
    _port_checkpoint(tgen, tmp_path / "ckpt")
    scan = tmp_path / "scan.mhd"
    jio.write_mhd(_vol_from(rng, (32, 30, 24)), scan, spacing=(0.4, 0.5, 0.625), origin=(1.0, 2.0, 3.0),
                  direction=ROT20)
    kw = dict(inference_patch_size=PATCH, overlap=0.5, batch_size=3)
    jcorr = JaxCorrector(jgen, variables["params"], variables["batch_stats"], layout="direct",
                         dtype=jnp.dtype(dtype), **kw)
    jcorr.correct_file(scan, tmp_path / "jax.mhd")
    pcorr = CCTAContrastCorrector.from_checkpoint(tmp_path / "ckpt", device="cpu", dtype=getattr(torch, dtype),
                                                  layout="direct", **kw)
    got_f32 = pcorr.correct_file(scan, tmp_path / "port.mhd")
    (got, gmeta), (want, wmeta) = jio.read_mhd(tmp_path / "port.mhd"), jio.read_mhd(tmp_path / "jax.mhd")
    assert got.dtype == np.int16
    assert np.abs(got.astype(np.int32) - want).max() <= 1
    assert (got == want).mean() >= 0.999, (got == want).mean()
    for k in wmeta:
        np.testing.assert_array_equal(gmeta[k], wmeta[k])
    # the file holds the returned volume, rounded half to even
    np.testing.assert_array_equal(got, np.clip(np.round(got_f32), -32768, 32767).astype(np.int16))
    if dtype == "bfloat16":
        f32 = CCTAContrastCorrector.from_checkpoint(tmp_path / "ckpt", device="cpu", layout="direct",
                                                    **kw).correct_file(scan)
        assert not np.array_equal(f32, got_f32)  # the bf16 patches reached the generator


def test_device_int16_matches_jax():
    x = np.array([-40000.0, -32768.6, -2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.49, 32767.4, 32767.6, 1e9], np.float32)
    got = device_int16(torch.from_numpy(x))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_device_int16(jnp.asarray(x))))


# --- the cohort function and the command -------------------------------------


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """A .mhd scan, a .nii.gz scan and a preprocessed .npy patient written
    with the port's writers, and a seeded tiny generator."""
    root = tmp_path_factory.mktemp("cohort")
    rng = np.random.default_rng(5)
    geo = dict(spacing=(0.4, 0.5, 0.625), origin=(-1.0, 2.0, 30.0))
    pio.write_mhd(_vol_from(rng), root / "scan_a.mhd", **geo)
    pio.write_nifti(_vol_from(rng, (20, 24, 18)), root / "scan_b.nii.gz", direction=ROT20, **geo)
    npy = write_patient(_vol_from(rng, (18, 16, 20)), (rng.random((18, 16, 20)) < 0.01), {
        "spacing": np.array(geo["spacing"]), "offset": np.array(geo["origin"]),
        "centerlines_world": np.zeros((0, 4), np.float32)}, "patient_c", root)
    torch.manual_seed(7)
    gen = ResnetGenerator(**GEN)
    return [root / "scan_a.mhd", root / "scan_b.nii.gz", npy], gen


def _corrector(gen):
    return CCTAContrastCorrector(gen, inference_patch_size=PATCH, batch_size=2, device="cpu")


def _files(d: Path) -> dict:
    return {p.name: (gzip.decompress(p.read_bytes()) if p.name.endswith(".gz") else p.read_bytes())
            for p in sorted(d.iterdir())}


@pytest.mark.parametrize("suffix", [".mhd", ".nii.gz"])
def test_overlapped_cohort_equals_the_sequential_one(cohort, tmp_path, suffix):
    paths, gen = cohort
    corr = _corrector(gen)
    seq = correct_patients(corr, tmp_path / "seq", paths, overlap_io=False, suffix=suffix)
    ovl = parallel_correct_patients(corr, tmp_path / "ovl", paths, suffix=suffix)
    assert [p.name for p in seq] == [p.name for p in ovl] == [f"scan_a{suffix}", f"scan_b{suffix}",
                                                              f"patient_c{suffix}"]
    assert _files(tmp_path / "seq") == _files(tmp_path / "ovl")
    for src, out in zip(paths, ovl):
        scan, meta = load_patient_or_scan(src)
        jscan, jmeta = jax_load_patient_or_scan(src)
        np.testing.assert_array_equal(scan, jscan)
        written, wmeta = pio.read_image(out)  # as written: no reorientation, no clip
        np.testing.assert_array_equal(written, device_int16(corr(scan)).numpy())
        np.testing.assert_allclose(wmeta["spacing"], meta["spacing"], rtol=1e-6)  # NIfTI stores f4
    one = correct_patient(corr, tmp_path / "one", paths[1], suffix=suffix)
    assert _files(tmp_path / "one")[one.name] == _files(tmp_path / "ovl")[one.name]


@pytest.mark.parametrize("overlap_io", [True, False])
def test_stop_requested_stops_between_volumes(cohort, tmp_path, overlap_io):
    paths, gen = cohort
    polls = []

    def stop():
        polls.append(1)
        return len(polls) > 1

    done = correct_patients(_corrector(gen), tmp_path, paths, overlap_io=overlap_io, stop_requested=stop)
    assert [p.name for p in done] == ["scan_a.mhd"]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["scan_a.mhd", "scan_a.raw"]


@pytest.mark.parametrize("where", ["loader", "writer"])
def test_an_error_in_either_thread_surfaces(cohort, tmp_path, where):
    paths, gen = cohort
    corr = _corrector(gen)

    def load_fn(p):
        if where == "loader" and p == paths[1]:
            raise OSError("unreadable scan")
        return load_patient_or_scan(p)

    def save_fn(corrected, path, meta):
        if where == "writer" and path.name.startswith("scan_b"):
            raise OSError("disk full")
        corr.save(corrected, path, meta)

    with pytest.raises(OSError, match="unreadable scan" if where == "loader" else "disk full"):
        correct_patients(corr, tmp_path, paths, load_fn=load_fn, save_fn=save_fn)
    assert not (tmp_path / "patient_c.mhd").exists()
    if where == "writer":  # written before the failing one
        assert (tmp_path / "scan_a.mhd").exists()


def test_correct_scans_command_writes_the_outputs(cohort, tmp_path):
    """``main`` in-process on a port checkpoint, then ``python -m`` once."""
    paths, gen = cohort
    _port_checkpoint(gen, tmp_path / "ckpt")
    args = [str(tmp_path / "ckpt"), str(tmp_path / "out"), *map(str, paths), "--patch-size", "16", "16", "16",
            "--batch-size", "2", "--output-format", "nii", "--device", "cpu"]
    deterministic = torch.backends.cudnn.deterministic
    done = correct_scans.main(args)
    assert torch.backends.cudnn.deterministic == deterministic  # held only for the command's run
    assert [p.name for p in done] == ["scan_a.nii", "scan_b.nii", "patient_c.nii"]
    corr = _corrector(gen)
    for src, out in zip(paths, done):
        np.testing.assert_array_equal(pio.read_image(out)[0], device_int16(corr(load_patient_or_scan(src)[0])).numpy())
    res = subprocess.run([sys.executable, "-m", "contrast_gan_3d_tpu_torch.correct_scans", *args[:3],
                          "--patch-size", "16", "16", "16", "--output-format", "mhd", "--device", "cpu",
                          "--iteration", "0"],
                         cwd=Path(__file__).resolve().parents[1], capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr[-2000:]
    assert (tmp_path / "out" / "scan_a.mhd").exists()


@pytest.mark.parametrize("flag", [["--reference-pt"], ["--sharded"], ["--output-format", "h5"]])
def test_correct_scans_unported_options_point_at_the_roadmap(tmp_path, flag):
    """``--reference-pt``, ``--sharded`` and ``--output-format h5`` raised
    until they were ported; they now read the checkpoint they are given (a
    missing one is a missing file; the corrections themselves are held in
    ``tests/test_torch_port_reference_ckpt.py``,
    ``tests/test_torch_port_cli.py`` and ``tests/test_torch_port_hdf5.py``)."""
    args = [str(tmp_path / "none.pt"), str(tmp_path / "out"), "x.mhd", *flag, "--device", "cpu"]
    with pytest.raises(FileNotFoundError):
        correct_scans.main(args)


def test_correct_scans_defaults_to_the_card(cohort, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the rule under test is its absence")
    paths, gen = cohort
    _port_checkpoint(gen, tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="cuda"):
        correct_scans.main([str(tmp_path / "ckpt"), str(tmp_path / "out"), str(paths[0])])
    assert not (tmp_path / "out").exists()


def test_port_paths_honour_the_environment(monkeypatch, tmp_path):
    assert paths.PROJECT_DIR == jax_paths.PROJECT_DIR and paths.LOGS_DIR == jax_paths.LOGS_DIR
    monkeypatch.setenv("CGAN3D_LOGS_DIR", str(tmp_path / "logs"))
    try:
        importlib.reload(paths)
        assert paths.LOGS_DIR == tmp_path / "logs"
    finally:
        monkeypatch.undo()
        importlib.reload(paths)
