"""HDF5 patients, corpora and scans in the port (``contrast_gan_3d_tpu_torch/
data/hdf5.py`` and its wiring), the counterparts of ``tests/test_hdf5.py``'s
cases, each held to the JAX package where it has an answer: the same files
(a file either package writes is read alike by the other, and the two
write the same bytes), the same addresses and shards, the same crops and
sampler batches (bit-identical to JAX's sampler on the same corpus and to
the port's own ``.npy`` batches). Then what the port adds: without h5py
(the card's machine) every module imports and an ``.h5`` path raises
``ImportError`` naming h5py while ``.npy`` patients load; and the
commands that take HDF5 (``correct_scans --output-format h5`` on corpus
members, ``validate_learning --data-format h5``).
"""

import importlib.util
import logging
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from contrast_gan_3d_tpu import native as jax_native
from contrast_gan_3d_tpu.data import hdf5 as jax_hdf5
from contrast_gan_3d_tpu.data import preprocess as jax_pre
from contrast_gan_3d_tpu.data.sampler import CCTAPatchSampler as JaxSampler
from contrast_gan_3d_tpu.utils import io_utils as jax_io
from contrast_gan_3d_tpu_torch import correct_scans, create_dataset, native, validate_learning
from contrast_gan_3d_tpu_torch.data import hdf5
from contrast_gan_3d_tpu_torch.data.labeling import divide_scans_in_fold
from contrast_gan_3d_tpu_torch.data.pipeline import PrefetchLoader, create_loaders
from contrast_gan_3d_tpu_torch.data.preprocess import create_patient, load_patient, write_patient
from contrast_gan_3d_tpu_torch.data.sampler import CCTAPatchSampler
from contrast_gan_3d_tpu_torch.eval.utils import load_patient_or_scan
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.parallel.multihost import host_fold_shard
from contrast_gan_3d_tpu_torch.utils import io_utils
from tests.synth import synthetic_patient
from tests.test_torch_port_serving_files import _port_checkpoint

REPO = Path(__file__).resolve().parents[1]
PATCH = (16, 16, 16)
TINY_GEN = dict(n_resnet_blocks=1, n_updownsample_blocks=1, init_channels_out=2)


def _per_label_corpora(root, rng, n=2, shape=(12, 12, 12)):
    """One corpus file per label (``opt.h5``, ``low.h5``, ``high.h5``) of
    ``n`` patients each, written by the port; the fold naming the files."""
    files = {}
    for label, fname in [(0, "opt.h5"), (-1, "low.h5"), (1, "high.h5")]:
        for i in range(n):
            vol, mask, _, meta = synthetic_patient(rng, shape=shape)
            hdf5.write_patient_h5(vol, mask, meta, f"p{i}", root / fname)
        files[label] = str(root / fname)
    return [(files[0], 0), (files[-1], -1), (files[1], 1)]


def test_standalone_roundtrip(tmp_path, rng):
    """A standalone patient: the port's file is byte for byte the JAX
    package's, and each package reads the other's alike."""
    vol, mask, ctls, meta = synthetic_patient(rng)
    path = hdf5.write_patient_h5(vol, mask, meta, "p0", tmp_path / "port")
    jpath = jax_hdf5.write_patient_h5(vol, mask, meta, "p0", tmp_path / "jax")
    assert path.endswith("p0.h5") and Path(path).read_bytes() == Path(jpath).read_bytes()
    for p in (path, jpath):
        data, got = hdf5.open_patient_h5(p)
        jdata, jgot = jax_hdf5.open_patient_h5(p)
        assert data.shape == (*vol.shape, 2) and data.dtype == np.int16
        np.testing.assert_array_equal(np.asarray(data[..., 0]), vol)
        np.testing.assert_array_equal(np.asarray(data[..., 1]), mask.astype(np.int16))
        np.testing.assert_array_equal(np.asarray(jdata), np.asarray(data))
        np.testing.assert_allclose(got["spacing"], meta["spacing"])
        np.testing.assert_allclose(got["offset"], meta["offset"])
        np.testing.assert_allclose(got["centerlines_world"], ctls)
        np.testing.assert_allclose(got["ostia_world"], meta["ostia_world"])
        assert got["name"] == jgot["name"] == "p0" and set(got) == set(jgot)


def test_corpus_members_addressing_and_sharding(tmp_path, rng):
    """Corpus members address as ``file.h5::name``, list and shard as in
    the JAX package (a deterministic disjoint cover); the two packages'
    corpus files are the same bytes."""
    corpus, jcorpus = tmp_path / "corpus.h5", tmp_path / "jax.h5"
    names = ["a", "b", "c"]
    written = []
    for name in names:
        vol, mask, _, meta = synthetic_patient(rng, shape=(12, 12, 12))
        written.append(hdf5.write_patient_h5(vol, mask, meta, name, corpus))
        jax_hdf5.write_patient_h5(vol, mask, meta, name, jcorpus)
    assert written == [f"{corpus}::{n}" for n in names]
    assert corpus.read_bytes() == jcorpus.read_bytes()
    members = hdf5.corpus_members(corpus)
    assert members == written == jax_hdf5.corpus_members(corpus)
    for member in members:
        data, meta = hdf5.open_patient_h5(member)
        assert data.shape == (12, 12, 12, 2)
        assert meta["name"] == member.split(hdf5.MEMBER_SEP)[1]
    shards = [hdf5.shard_members(members, i, 2) for i in range(2)]
    assert shards == [jax_hdf5.shard_members(members, i, 2) for i in range(2)]
    assert sorted(shards[0] + shards[1]) == sorted(members) and not set(shards[0]) & set(shards[1])
    with pytest.raises(ValueError, match="shard 2 of 2"):
        hdf5.shard_members(members, 2, 2)
    assert hdf5.split_member(written[0]) == jax_hdf5.split_member(written[0]) == (str(corpus), "a")
    for p in ("x.H5", "y.hdf5", "c.h5::m", "z.npy", "d/h5"):
        assert hdf5.is_hdf5_path(p) == jax_hdf5.is_hdf5_path(p)


def test_corpus_rewrite_replaces_member(tmp_path, rng):
    corpus = tmp_path / "c.h5"
    vol, mask, _, meta = synthetic_patient(rng, shape=(8, 8, 8))
    hdf5.write_patient_h5(vol, mask, meta, "p", corpus)
    hdf5.write_patient_h5(vol + 1, mask, meta, "p", corpus)
    assert hdf5.corpus_members(corpus) == [f"{corpus}::p"]
    data, _ = jax_hdf5.open_patient_h5(f"{corpus}::p")
    np.testing.assert_array_equal(np.asarray(data[..., 0]), vol + 1)


def test_missing_member_error_names_available(tmp_path, rng):
    corpus = tmp_path / "c.h5"
    vol, mask, _, meta = synthetic_patient(rng, shape=(8, 8, 8))
    hdf5.write_patient_h5(vol, mask, meta, "present", corpus)
    with pytest.raises(KeyError, match="present"):
        hdf5.open_patient_h5(f"{corpus}::absent")


def test_corpus_fd_shared_across_members(tmp_path, rng):
    """One file handle per corpus file: a missing member leaves the shared
    handle open for the others, and the sampler shares one through
    ``load_patient``."""
    corpus = tmp_path / "c.h5"
    members = []
    for i in range(4):
        vol, mask, _, meta = synthetic_patient(rng, shape=(12, 12, 12))
        members.append(hdf5.write_patient_h5(vol, mask, meta, f"p{i}", corpus))
    cache = {}
    datasets = [hdf5.open_patient_h5(m, file_cache=cache) for m in members]
    assert len(cache) == 1
    for (data, meta), m in zip(datasets, members):
        assert data.shape == (12, 12, 12, 2) and meta["name"] == m.split(hdf5.MEMBER_SEP)[1]
    with pytest.raises(KeyError, match="absent"):
        hdf5.open_patient_h5(f"{corpus}::absent", file_cache=cache)
    assert datasets[0][0][0, 0, 0, 0] is not None
    sampler = CCTAPatchSampler(members, (8, 8, 8), 2, rng=np.random.default_rng(0))
    for _ in range(4):
        sampler.next_batch()
    assert len(sampler._h5_files) == 1


def test_load_patient_dispatch(tmp_path, rng):
    """``load_patient`` takes a standalone ``.h5`` patient and a corpus
    member as it takes ``.npy``; ``write_patient(fmt="h5")`` and a ``.h5``
    out_dir return what JAX's return."""
    vol, mask, _, meta = synthetic_patient(rng, shape=(10, 10, 10))
    standalone = write_patient(vol, mask, meta, "s", tmp_path, fmt="h5")
    member = write_patient(vol, mask, meta, "m", tmp_path / "corpus.h5")
    assert (standalone, member) == (str(tmp_path / "s.h5"), f"{tmp_path / 'corpus.h5'}::m")
    for path in (standalone, member):
        data, got = load_patient(path)
        jdata, jgot = jax_pre.load_patient(path)
        assert data.shape == (10, 10, 10, 2)
        np.testing.assert_array_equal(np.asarray(data[..., 0]), vol)
        np.testing.assert_array_equal(np.asarray(data), np.asarray(jdata))
        assert "spacing" in got and "centerlines_world" in got and set(got) == set(jgot)
    with pytest.raises(ValueError, match="unknown patient format"):
        write_patient(vol, mask, meta, "x", tmp_path, fmt="zarr")


def test_compressed_corpus_roundtrip(tmp_path, rng):
    vol, mask, ctls, meta = synthetic_patient(rng, shape=(16, 16, 16))
    path = hdf5.write_patient_h5(vol, mask, meta, "gz", tmp_path / "c.h5", compression="gzip")
    jpath = jax_hdf5.write_patient_h5(vol, mask, meta, "gz", tmp_path / "j.h5", compression="gzip")
    assert (tmp_path / "c.h5").read_bytes() == (tmp_path / "j.h5").read_bytes()
    for p in (path, jpath):
        data, got = hdf5.open_patient_h5(p)
        np.testing.assert_array_equal(np.asarray(data[..., 0]), vol)
        np.testing.assert_allclose(got["centerlines_world"], ctls)


def test_crop_pad_matches_ndarray_on_h5(tmp_path, rng):
    """The native crop takes the h5py dataset by a windowed read: the same
    windows (negative and overhanging too) as the C crop of the ndarray and
    as the JAX package's crop of the same dataset."""
    vol, mask, _, meta = synthetic_patient(rng, shape=(12, 14, 10))
    packed = np.stack([vol, mask.astype(np.int16)], axis=-1)
    data, _ = hdf5.open_patient_h5(hdf5.write_patient_h5(vol, mask, meta, "p", tmp_path))
    for start in ([0, 0, 0], [-3, 5, -2], [8, 10, 6], [-20, -20, -20]):
        got = native.crop_pad_int16(data, start, (8, 8, 8))
        np.testing.assert_array_equal(got, native.crop_pad_int16(packed, start, (8, 8, 8)))
        np.testing.assert_array_equal(got, jax_native.crop_pad_int16(data, start, (8, 8, 8)))


def _batches(sampler, n):
    return [sampler.next_batch() for _ in range(n)]


@pytest.mark.parametrize("patch", [PATCH, (16, 16)])
def test_sampler_identical_batches_npy_vs_h5(tmp_path, patch):
    """Same patients, same seed: the port's sampler over an HDF5 corpus
    gives the batches its ``.npy`` sampler gives and the JAX sampler gives
    over the same corpus, bit for bit (3D and the 2D centerline-guided
    slices)."""
    seed_rng = np.random.default_rng(11)
    vols = [synthetic_patient(seed_rng, shape=(20, 20, 20)) for _ in range(3)]
    npy_paths, h5_paths = [], []
    for i, (vol, mask, _, meta) in enumerate(vols):
        npy_paths.append(str(write_patient(vol, mask, meta, f"p{i}", tmp_path / "npy")))
        h5_paths.append(write_patient(vol, mask, meta, f"p{i}", tmp_path / "c.h5"))
    a = CCTAPatchSampler(npy_paths, patch, 2, rng=np.random.default_rng(5))
    b = CCTAPatchSampler(h5_paths, patch, 2, rng=np.random.default_rng(5))
    j = JaxSampler(h5_paths, patch, 2, rng=np.random.default_rng(5))
    for ba, bb, bj in zip(_batches(a, 6), _batches(b, 6), _batches(j, 6)):
        for k in ("data", "seg"):
            np.testing.assert_array_equal(ba[k], bb[k])
            np.testing.assert_array_equal(bb[k], bj[k])


def test_prefetch_loader_over_corpus(tmp_path, rng):
    """Two prefetch threads read one corpus file."""
    fold = _per_label_corpora(tmp_path, rng, n=1, shape=(24, 24, 24))
    paths = [p for ps in divide_scans_in_fold(fold).values() for p in ps]
    loader = PrefetchLoader(CCTAPatchSampler(paths, PATCH, batch_size=2, rng=rng), num_threads=2, prefetch=2,
                            to_device=False)
    loader.start()
    try:
        for _ in range(4):
            batch = next(loader)
            assert batch["data"].shape == (2, *PATCH) and batch["data"].dtype == np.int16
    finally:
        loader.stop()


def _raw_h5_patient(tmp_path, rng):
    shape, spacing, offset = (16, 16, 8), (0.5, 0.5, 1.0), (-4.0, -4.0, 0.0)
    vol = rng.integers(-200, 800, shape, dtype=np.int16)
    jax_io.write_hdf5_image(vol, tmp_path / "p1.h5", spacing=np.asarray(spacing), origin=np.asarray(offset))
    pdir = tmp_path / "p1"
    pdir.mkdir()
    (pdir / "vessel0.txt").write_text("-3.0 -3.0 2.0 0.5\n0.0 0.0 5.0 0.5\n")
    (pdir / "ostia.xml").write_text("<XMarkerList><ListSize>2</ListSize>"
                                    "<Item><pos>-3 -3 2</pos></Item><Item><pos>0 0 5</pos></Item></XMarkerList>")
    return vol, spacing, offset, pdir


def test_create_patient_h5_end_to_end(tmp_path, rng):
    """A raw HDF5 scan -> ``create_patient`` -> an HDF5 corpus member: the
    same patient as the ``.mhd`` -> ``.npy`` route of the same inputs, and
    the same bytes as the JAX package's corpus."""
    vol, spacing, offset, pdir = _raw_h5_patient(tmp_path, rng)
    out_h5 = create_patient(tmp_path / "p1.h5", pdir, pdir / "ostia.xml", tmp_path / "corpus.h5", device="cpu")
    assert out_h5 == f"{tmp_path / 'corpus.h5'}::p1"
    jax_pre.create_patient(tmp_path / "p1.h5", pdir, pdir / "ostia.xml", tmp_path / "jax.h5")
    assert (tmp_path / "corpus.h5").read_bytes() == (tmp_path / "jax.h5").read_bytes()
    data_h5, meta_h5 = load_patient(out_h5)
    io_utils.write_mhd(vol, tmp_path / "p1.mhd", spacing=np.asarray(spacing), origin=np.asarray(offset))
    data_npy, meta_npy = load_patient(create_patient(tmp_path / "p1.mhd", pdir, pdir / "ostia.xml",
                                                     tmp_path / "out", device="cpu"))
    np.testing.assert_array_equal(np.asarray(data_h5), np.asarray(data_npy))
    for k in ("spacing", "offset", "centerlines_world"):
        np.testing.assert_allclose(meta_h5[k], meta_npy[k])


def test_load_scan_hdf5_matches_mhd(tmp_path, rng):
    """``load_scan`` treats an HDF5 raw scan as the same volume in ``.mhd``
    (reorientation, HU shift and clip, int16), as the JAX package does; the
    port's HDF5 image is the JAX package's, byte for byte."""
    vol = rng.integers(-3000, 4000, (10, 12, 8)).astype(np.int32)
    spacing, offset = np.array([0.7, 0.8, 1.1]), np.array([1.0, -2.0, 3.0])
    io_utils.write_hdf5_image(vol, tmp_path / "s.h5", spacing=spacing, origin=offset)
    jax_io.write_hdf5_image(vol, tmp_path / "j.h5", spacing=spacing, origin=offset)
    assert (tmp_path / "s.h5").read_bytes() == (tmp_path / "j.h5").read_bytes()
    io_utils.write_mhd(vol.astype(np.int16), tmp_path / "s.mhd", spacing=spacing, origin=offset)
    got, meta_h5 = io_utils.load_scan(tmp_path / "s.h5")
    want, meta_mhd = io_utils.load_scan(tmp_path / "s.mhd")
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_io.load_scan(tmp_path / "s.h5")[0])
    np.testing.assert_allclose(meta_h5["spacing"], meta_mhd["spacing"])
    np.testing.assert_allclose(meta_h5["offset"], meta_mhd["offset"])
    assert meta_h5["orientation"] == meta_mhd["orientation"] == "LPS"


def test_stem_strips_h5_suffix():
    for name in ("1.2.840.113.h5", "scan.hdf5", "c.h5::member"):
        assert io_utils.stem(name) == jax_io.stem(name)
    assert io_utils.stem("1.2.840.113.h5") == "1.2.840.113" and io_utils.stem("scan.hdf5") == "scan"


def test_load_patient_or_scan_h5_schemas(tmp_path, rng):
    """A preprocessed HDF5 patient (``scan_and_mask``) and a raw HDF5 scan
    (``image``) told apart by the schema, as JAX's loader tells them."""
    from contrast_gan_3d_tpu.eval.utils import load_patient_or_scan as jax_load

    vol, mask, _, meta = synthetic_patient(rng, shape=(10, 10, 6))
    member = hdf5.write_patient_h5(vol, mask, meta, "p", tmp_path / "c.h5")
    got, m = load_patient_or_scan(member)
    np.testing.assert_array_equal(got, vol)
    assert "centerlines_world" in m
    raw = rng.integers(-500, 900, size=(8, 8, 4)).astype(np.int16)
    io_utils.write_hdf5_image(raw, tmp_path / "raw.h5")
    got2, m2 = load_patient_or_scan(tmp_path / "raw.h5")
    np.testing.assert_array_equal(got2, raw)
    np.testing.assert_array_equal(got2, jax_load(tmp_path / "raw.h5")[0])
    assert m2["orientation"] == "LPS"


def test_fold_corpus_file_expansion(tmp_path, rng):
    """A fold entry naming a per-label corpus file expands to its members
    under that label, as the JAX package's; the loaders build from it."""
    from contrast_gan_3d_tpu.data.labeling import divide_scans_in_fold as jax_divide

    fold = _per_label_corpora(tmp_path, rng, shape=(20, 20, 20))
    by_label = divide_scans_in_fold(fold)
    assert by_label == jax_divide(fold)
    assert {k: len(v) for k, v in by_label.items()} == {0: 2, -1: 2, 1: 2}
    assert all(hdf5.MEMBER_SEP in p for ps in by_label.values() for p in ps)
    loaders = create_loaders(fold, PATCH, {0: 2, -1: 1, 1: 1}, rng, num_threads=1, to_device=False)
    try:
        for loader in loaders.values():
            loader.start()
        assert next(loaders[0])["data"].shape == (2, *PATCH)
        assert next(loaders[-1])["data"].shape == (1, *PATCH)
    finally:
        for loader in loaders.values():
            loader.stop()


def test_host_fold_shard_single_process(tmp_path, rng):
    """One host keeps the whole expanded fold; H hosts deal each label's
    members round-robin (``shard_members``), a disjoint cover whose
    shards open only their own members."""
    fold = _per_label_corpora(tmp_path, rng, n=4)
    shard = host_fold_shard(fold)
    assert sorted(label for _, label in shard) == [-1] * 4 + [0] * 4 + [1] * 4
    assert all(hdf5.MEMBER_SEP in p for p, _ in shard)
    members = divide_scans_in_fold(fold)
    shards = [host_fold_shard(fold, h, 4) for h in range(4)]
    for h, got in enumerate(shards):
        assert got == [(p, label) for label, ps in members.items() for p in jax_hdf5.shard_members(ps, h, 4)]
    assert sorted(p for s in shards for p, _ in s) == sorted(p for p, _ in shard)


def _jax_create_dataset():
    spec = importlib.util.spec_from_file_location("jax_create_dataset", REPO / "scripts" / "create_dataset.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_create_dataset_script_mixed_formats(tmp_path, rng):
    """``create_dataset`` labels a directory holding ``.npy`` patients and
    an HDF5 corpus (listed as the JAX script lists them); the split pickle
    carries corpus members that ``load_patient`` resolves."""
    import pickle

    pdir = tmp_path / "patients"
    for i in range(3):
        vol, mask, _, meta = synthetic_patient(rng, shape=(24, 24, 24))
        write_patient(vol, mask, meta, f"npy{i}", pdir)
    for i in range(3):
        vol, mask, _, meta = synthetic_patient(rng, shape=(24, 24, 24))
        hdf5.write_patient_h5(vol, mask, meta, f"h5{i}", pdir / "corpus.h5")
    assert create_dataset.patient_paths(pdir) == _jax_create_dataset().patient_paths(pdir)
    create_dataset.main([str(pdir), str(tmp_path / "dataset"), "--n-folds", "2", "--device", "cpu"])
    with open(tmp_path / "dataset" / "cross_val_splits.pkl", "rb") as fd:
        splits = pickle.load(fd)
    paths = {p for fold in splits["train"] + splits["test"] for p, _ in fold}
    assert sum(hdf5.MEMBER_SEP in p for p in paths) == 3 and sum(p.endswith(".npy") for p in paths) == 3
    data, _ = load_patient(next(p for p in paths if hdf5.MEMBER_SEP in p))
    assert data.shape == (24, 24, 24, 2)


def test_missing_corpus_member_error_not_masked(tmp_path, rng):
    """A bad member address raises the diagnostic ``KeyError``, not a
    raw-scan reader's format error."""
    vol, mask, _, meta = synthetic_patient(rng, shape=(8, 8, 8))
    hdf5.write_patient_h5(vol, mask, meta, "present", tmp_path / "c.h5")
    with pytest.raises(KeyError, match="present"):
        load_patient_or_scan(f"{tmp_path / 'c.h5'}::absent")


def test_uppercase_h5_suffix_dispatch(tmp_path, rng):
    raw = rng.integers(-500, 900, size=(6, 6, 4)).astype(np.int16)
    io_utils.write_hdf5_image(raw, tmp_path / "SCAN.H5")
    got, meta = load_patient_or_scan(tmp_path / "SCAN.H5")
    np.testing.assert_array_equal(got, raw)
    assert meta["orientation"] == "LPS"


def test_create_dataset_rejects_raw_h5(tmp_path, rng):
    """``patient_paths`` fails on an HDF5 file that is neither a patient
    nor a corpus (a raw scan), and on a directory without patients."""
    io_utils.write_hdf5_image(rng.integers(-500, 900, size=(6, 6, 4)).astype(np.int16), tmp_path / "raw.h5")
    with pytest.raises(SystemExit, match="preprocess"):
        create_dataset.patient_paths(tmp_path / "raw.h5")
    with pytest.raises(SystemExit, match="no preprocessed patients"):
        create_dataset.patient_paths(tmp_path / "empty_does_not_glob")


def test_write_patient_h5_custom_chunks(tmp_path, rng):
    """``chunks=`` overrides the 64^3 default (z-thin chunks for 2D-slice
    corpora); the JAX package writes the same bytes."""
    vol = rng.integers(-1000, 1000, (80, 70, 9), dtype=np.int16)
    mask = (rng.random((80, 70, 9)) < 0.01).astype(np.int16)
    meta = {"spacing": np.ones(3), "offset": np.zeros(3)}
    path = hdf5.write_patient_h5(vol, mask, meta, "p0", tmp_path, chunks=(64, 64, 1, 2))
    jpath = jax_hdf5.write_patient_h5(vol, mask, meta, "p0", tmp_path / "jax", chunks=(64, 64, 1, 2))
    assert Path(path).read_bytes() == Path(jpath).read_bytes()
    with h5py.File(path, "r") as fd:
        assert fd[hdf5.SCAN_DS].chunks == (64, 64, 1, 2)
        np.testing.assert_array_equal(fd[hdf5.SCAN_DS][..., 0], vol)


WITHOUT_H5PY = '''
import sys
sys.modules["h5py"] = None  # as on the card's machine: ``import h5py`` raises ImportError
import importlib, pkgutil
import numpy as np
import contrast_gan_3d_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from contrast_gan_3d_tpu_torch.data import hdf5
from contrast_gan_3d_tpu_torch.data.preprocess import load_patient, write_patient
from contrast_gan_3d_tpu_torch.eval.utils import load_patient_or_scan
from contrast_gan_3d_tpu_torch.utils import io_utils
out = sys.argv[1]
vol = np.zeros((4, 4, 4), np.int16)
npy = write_patient(vol, vol, {"spacing": np.ones(3)}, "p", out)
assert load_patient(npy)[0].shape == (4, 4, 4, 2)
calls = [lambda: load_patient(out + "/c.h5::p"), lambda: write_patient(vol, vol, {}, "q", out, fmt="h5"),
         lambda: write_patient(vol, vol, {}, "q", out + "/c.h5"), lambda: io_utils.load_scan(out + "/a.h5"),
         lambda: io_utils.save_scan(vol, None, None, out + "/a.h5"), lambda: load_patient_or_scan(out + "/a.h5"),
         lambda: hdf5.corpus_members(out + "/c.h5")]
for call in calls:
    try:
        call()
    except ImportError as e:
        assert "h5py" in str(e), e
    else:
        raise AssertionError("an .h5 path without h5py did not raise ImportError")
print("ok", len(calls))
'''


def test_without_h5py_imports_succeed_and_h5_paths_raise(tmp_path):
    """The card's machine has no h5py: every module of the port imports,
    ``.npy`` patients write and load, and each ``.h5`` path (patients,
    corpora, scans, saving) raises ``ImportError`` naming h5py."""
    res = subprocess.run([sys.executable, "-c", WITHOUT_H5PY, str(tmp_path)], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.split() == ["ok", "7"], res.stderr[-3000:]


def test_correct_scans_reads_corpus_members_and_writes_h5(tmp_path, rng):
    """``correct_scans --output-format h5`` on a corpus member: the
    corrected ``.h5`` scan (read by JAX's reader) holds what the ``.mhd``
    output of the same member holds."""
    vol, mask, _, meta = synthetic_patient(rng, shape=(20, 20, 16))
    member = write_patient(vol, mask, meta, "pc", tmp_path / "c.h5")
    torch.manual_seed(7)
    _port_checkpoint(ResnetGenerator(**TINY_GEN), tmp_path / "ckpt")
    common = [str(tmp_path / "ckpt"), "--patch-size", "16", "16", "16", "--batch-size", "2", "--device", "cpu"]
    got = correct_scans.main([common[0], str(tmp_path / "h5"), member, *common[1:], "--output-format", "h5"])
    want = correct_scans.main([common[0], str(tmp_path / "mhd"), member, *common[1:]])
    assert [p.name for p in got] == ["pc.h5"] and [p.name for p in want] == ["pc.mhd"]
    h5_vol, h5_meta = jax_io.read_image(got[0])
    mhd_vol, mhd_meta = io_utils.read_image(want[0])
    np.testing.assert_array_equal(h5_vol, mhd_vol)
    np.testing.assert_allclose(h5_meta["spacing"], mhd_meta["spacing"])


def test_validate_learning_h5_trains_from_one_corpus(tmp_path, caplog):
    """``validate_learning --data-format h5``: the cohort in one corpus
    file, the run trained from its members; the same batches as the
    ``.npy`` run, so the same summary."""
    caplog.set_level(logging.WARNING)
    argv = ["--iterations", "2", "--cycle-length", "1", "--device", "cpu"]
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite's workers share the cores
    try:
        npy = validate_learning.main([*argv, "--workdir", str(tmp_path / "npy")])
        h5 = validate_learning.main([*argv, "--workdir", str(tmp_path / "h5"), "--data-format", "h5"])
    finally:
        torch.set_num_threads(threads)
    assert (tmp_path / "h5" / "data" / "corpus.h5").exists() and not list((tmp_path / "h5" / "data").glob("*.npy"))
    assert h5.pop("data_format") == "h5" and npy.pop("data_format") == "npy"
    assert h5 == npy
