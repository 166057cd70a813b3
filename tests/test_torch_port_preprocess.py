"""Offline preprocessing in the port against the JAX package, on the CPU: the
centerline and ostia parsers, the host geometry engine, the native
trilinear interpolation, the volume resampler and the world-patch sampler,
``create_patient`` and the ``preprocess`` command against JAX's
``create_patient`` and ``scripts/preprocess.py``.

Tolerances: the parsers, the geometry engine, nearest resampling and the
patients' masks and meta are exact. The f32 resampler and the world-patch
sampler agree within 1e-5 of max|x| (two f32 programs whose products and
sums may fuse differently). The int16 resampler rounds an f32 result half
to even. Lerps of integers at fractions such as 5/8 land exactly on .5
ties, and the two programs' last-bit f32 differences round such a voxel
either way (JAX's own resampler departs from the exact, f64, rounding at
such voxels too). So the rule is:
voxels at most 1 HU apart, and every voxel that differs has an exact value
within ``TIE_BAND`` of a half-integer (f32 carries ~5e-5 HU of error at
these magnitudes); the count is in the message.
``trilinear_f32`` is held to the numpy engine at rtol = atol = 1e-5, as the
JAX package's ``tests/test_native.py`` holds its own."""

import importlib.util
import pickle
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrast_gan_3d_tpu.data import preprocess as jax_pre
from contrast_gan_3d_tpu.data.labeling import label_from_HU as jax_label_from_HU
from contrast_gan_3d_tpu.ops import resample as jax_rs
from contrast_gan_3d_tpu.utils import geometry as jax_geom
from contrast_gan_3d_tpu.utils import io_utils as jax_io
from contrast_gan_3d_tpu_torch import native, preprocess
from contrast_gan_3d_tpu_torch.data import preprocess as port_pre
from contrast_gan_3d_tpu_torch.data.labeling import label_from_HU
from contrast_gan_3d_tpu_torch.ops import resample as port_rs
from contrast_gan_3d_tpu_torch.utils import geometry as port_geom
from contrast_gan_3d_tpu_torch.utils import io_utils as port_io

REPO = Path(__file__).resolve().parents[1]
F32_REL = 1e-5
TIE_BAND = 1e-3
# anisotropic, off-origin raw scans: the resampler and the rasterized mask
# both see non-trivial geometry
RAW_SPACING = (0.7, 0.8, 1.25)
RAW_ORIGIN = (-12.5, 3.25, 40.0)


def _raw_cohort(root: Path, rng, names=("pa", "pb"), shape=(40, 36, 24)):
    """Raw patients in ``preprocess``'s layout: ``<name>.mhd`` with
    ``<name>/vessel0.txt``, ``vessel1.txt`` and ``ostia.xml`` (world mm)."""
    root.mkdir(parents=True, exist_ok=True)
    extent = np.asarray(shape) * RAW_SPACING
    for name in names:
        vol = rng.normal(60, 150, shape).clip(-1024, 1500).astype(np.int16)
        vol[0, 0, 0] = -1000  # keeps load_scan's unsigned-offset shift off
        jax_io.write_mhd(vol, root / f"{name}.mhd", spacing=RAW_SPACING, origin=RAW_ORIGIN)
        pdir = root / name
        pdir.mkdir(exist_ok=True)
        for v in range(2):
            pts = RAW_ORIGIN + rng.uniform(-0.05, 1.05, (30, 3)) * extent  # a few outside the scan
            np.savetxt(pdir / f"vessel{v}.txt", np.concatenate([pts, rng.uniform(0.5, 2, (30, 1))], -1))
        ostia = RAW_ORIGIN + rng.uniform(0.3, 0.7, (2, 3)) * extent
        (pdir / "ostia.xml").write_text(
            "<XMarkerList>\n<ListSize>2</ListSize>\n"
            + "".join(f"<item><pos>{x} {y} {z} 1</pos><vec>0 0 1</vec></item>\n" for x, y, z in ostia)
            + "<item><pos>9 9 9</pos></item>\n</XMarkerList>\n")
    return root


# --- the parsers ----------------------------------------------------------------


def test_parsers_match_jax(tmp_path, rng):
    """``load_centerlines`` (two files, sorted, and an empty folder),
    ``load_mevis_coords`` (``ListSize`` cuts a third marker, vectors kept)
    and ``load_ASOCA_annotated_centerlines`` (and an empty file) return
    exactly JAX's arrays."""
    root = _raw_cohort(tmp_path, rng, names=("pa",))
    (tmp_path / "empty").mkdir()
    asoca = tmp_path / "asoca.txt"
    asoca.write_text("LAD 1.5 2 3 0.7\n\nRCA 4 5 6.25 1\nx\n")
    (tmp_path / "asoca_empty.txt").write_text("\n")
    cases = [
        (port_io.load_centerlines, jax_io.load_centerlines, root / "pa"),
        (port_io.load_centerlines, jax_io.load_centerlines, tmp_path / "empty"),
        (port_io.load_ASOCA_annotated_centerlines, jax_io.load_ASOCA_annotated_centerlines, asoca),
        (port_io.load_ASOCA_annotated_centerlines, jax_io.load_ASOCA_annotated_centerlines,
         tmp_path / "asoca_empty.txt"),
    ]
    for port_fn, jax_fn, arg in cases:
        got, want = port_fn(arg), jax_fn(arg)
        assert got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want), arg
    ostia = root / "pa" / "ostia.xml"
    got, want = port_io.load_mevis_coords(ostia), jax_io.load_mevis_coords(ostia)
    assert got[0].shape == (2, 3) and got[1].shape == (2, 3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


# --- the geometry engine --------------------------------------------------------


def _geometry_cases(rng):
    vol = rng.normal(0, 300, (9, 8, 7)).astype(np.float32)
    pts = rng.uniform(-3, 11, (50, 3)).astype(np.float32)
    offset, spacing = np.array([-2.0, 1.5, 4.0]), np.array([0.7, 0.8, 1.25])
    world = rng.uniform(-5, 15, (40, 3))
    return {
        "deg_to_radians": ((37.5,), {}),
        "world_to_image_coords": ((world, offset, spacing), {}),
        "image_to_world_coords": ((rng.integers(0, 9, (20, 3)), offset, spacing), {}),
        "trilinear_interpolate": ((vol, pts[:, 0], pts[:, 1], pts[:, 2]), {}),
        "sample_world_patch": ((vol, np.array([1.0, 4.5, 7.0]), spacing, np.array([5, 4, 3]),
                                np.array([0.5, 0.5, 0.6])), {}),
        "extract_ostia_patch": ((vol, np.array([[0.5, 2.0, 5.0], [9.0, 8.0, -1.0]]), offset, spacing), {}),
        "world_to_grid_coords": ((world, offset, spacing, (9, 8, 7)), {}),
        "grid_to_cartesian_coords": ((rng.integers(0, 2, (5, 4, 3)),), {}),
        "pointwise_euclidean_distance": ((world[:7], world[10:15]), {}),
        "get_patch_bounds": (((6, -1, 4), (9, 8, 7), np.array([1, 4, 6])), {}),
    }


@pytest.mark.parametrize("name", sorted(_geometry_cases(np.random.default_rng(0))))
def test_geometry_matches_jax(name):
    """Every geometry function gives JAX's result exactly (the ostia patch
    at the default 19^3, 0.5 mm, overhanging the volume)."""
    args, kw = _geometry_cases(np.random.default_rng(5))[name]
    got, want = getattr(port_geom, name)(*args, **kw), getattr(jax_geom, name)(*args, **kw)
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("mu", [-50.0, 250.0, 300.0, 300.5, 420.0, 499.9, 500.0, 900.0])
def test_label_from_hu_matches_jax(mu):
    assert label_from_HU(mu) == jax_label_from_HU(mu)


def test_trilinear_f32_matches_numpy(rng):
    """The native ``trilinear_f32`` against the numpy engine, points inside,
    in the border band and far outside (rtol = atol = 1e-5, JAX's own
    ``tests/test_native.py`` bound)."""
    vol = rng.normal(0, 100, (17, 13, 11)).astype(np.float32)
    xs, ys, zs = (rng.uniform(-4, n + 3, 2000).astype(np.float32) for n in vol.shape)
    got = native.trilinear_f32(vol, xs, ys, zs)
    want = port_geom.trilinear_interpolate(vol, xs, ys, zs)
    assert got.dtype == np.float32 and got.shape == (2000,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        native.trilinear_f32(vol[0], xs, ys, zs)


# --- the device geometry --------------------------------------------------------


def test_trilinear_sample_extrapolate_matches_jax(rng):
    """Single-channel and 2-channel volumes, points inside and overhanging
    every border: within 1e-5 of max|x| of JAX's sampler."""
    for shape in ((9, 8, 7), (9, 8, 7, 2)):
        vol = rng.normal(0, 300, shape).astype(np.float32)
        coords = rng.uniform(-3, 11, (6, 5, 3)).astype(np.float32)
        want = np.asarray(jax_rs.trilinear_sample_extrapolate(jnp.asarray(vol), jnp.asarray(coords)))
        got = port_rs.trilinear_sample_extrapolate(torch.from_numpy(vol)[None], torch.from_numpy(coords)[None])[0]
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_REL * np.abs(vol).max())


def test_device_world_patch_matches_jax_and_host(rng):
    """The device ``sample_world_patch`` on two centres at once (one patch
    overhanging the volume) against JAX's device sampler per centre and
    against the host ``extract_ostia_patch``, 19^3 at 0.5 mm."""
    vol = rng.normal(0, 300, (30, 26, 20)).astype(np.float32)
    spacing = np.array([0.7, 0.8, 1.25], np.float32)
    offset = np.array([-3.0, 2.0, 10.0])
    ostia = np.array([[4.0, 8.0, 22.0], [-1.0, 20.5, 30.0]])
    centers = (ostia - offset).astype(np.float32)
    size, step = (19, 19, 19), np.array([0.5] * 3, np.float32)
    got = port_rs.sample_world_patch(torch.from_numpy(vol), centers, spacing, size, step).numpy()
    assert got.shape == (2, *size)
    tol = F32_REL * np.abs(vol).max()
    for i, c in enumerate(centers):
        want = np.asarray(jax_rs.sample_world_patch(jnp.asarray(vol), jnp.asarray(c), jnp.asarray(spacing), size,
                                                    jnp.asarray(step)))
        np.testing.assert_allclose(got[i], want, rtol=0, atol=tol)
    host = port_geom.extract_ostia_patch(vol, ostia, offset, spacing.astype(np.float64))
    np.testing.assert_allclose(got, host, rtol=0, atol=tol)


# --- the volume resampler -------------------------------------------------------

RESAMPLE_CASES = {
    # (input shape, in spacing, out spacing, kwargs)
    "3d_aniso": ((48, 44, 30), (0.39, 0.39, 0.625), 0.5, {}),
    "3d_up": ((20, 18, 14), (1.0, 1.2, 2.0), (0.6, 0.7, 0.9), {}),
    "2d_channels": ((50, 42, 3), 0.8, 0.55, {"spatial_dims": 2}),
    "3d_trailing_channel": ((30, 28, 20, 2), (0.7, 0.8, 1.25), 0.5, {}),
    "3d_out_shape": ((36, 30, 20), (0.7, 0.8, 1.25), 0.5, {"out_shape": (40, 41, 43)}),
}


def exact_resample(volume, in_sp, out_sp, out_shape, spatial: int) -> np.ndarray:
    """The resampler's contractions in f64 on the host (the f32 matrices'
    entries, summed exactly enough to place every .5 tie)."""
    s_in = np.broadcast_to(np.asarray(in_sp, np.float64), (spatial,))
    s_out = np.broadcast_to(np.asarray(out_sp, np.float64), (spatial,))
    out = np.asarray(volume, np.float64)
    for axis in range(spatial):
        mat = port_rs.resample_axis_matrix(volume.shape[axis], out_shape[axis], s_out[axis] / s_in[axis])
        out = np.moveaxis(np.tensordot(mat.astype(np.float64), out, axes=(1, axis)), 0, axis)
    return out


def assert_int16_rule(got, want, exact, what=""):
    """At most 1 HU apart, and only at voxels whose exact value lies within
    ``TIE_BAND`` of a .5 tie."""
    diff = np.abs(got.astype(np.int32) - want)
    off = diff != 0
    tie_dist = np.abs(np.abs(exact - np.floor(exact)) - 0.5)
    assert diff.max() <= 1, f"{what}: max |diff| {diff.max()}"
    assert (tie_dist[off] <= TIE_BAND).all(), (
        f"{what}: {int((off & (tie_dist > TIE_BAND)).sum())} voxels differ away from a .5 tie")
    print(f"{what}: {int(off.sum())} of {diff.size} voxels differ by 1 HU, all at .5 ties")


def _resample_pair(volume, in_sp, out_sp, kw, method="linear"):
    want = jax_rs.resample_volume(volume, in_sp, out_sp, method=method, **kw)
    got = port_rs.resample_volume(volume, in_sp, out_sp, method=method, device="cpu", **kw)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.shape, want.shape)
    return got, want


@pytest.mark.parametrize("case", sorted(RESAMPLE_CASES))
def test_resample_f32_matches_jax(case):
    """float32 in, float32 out, within 1e-5 of max|x|."""
    shape, in_sp, out_sp, kw = RESAMPLE_CASES[case]
    vol = np.random.default_rng(7).normal(0, 400, shape).astype(np.float32)
    got, want = _resample_pair(vol, in_sp, out_sp, kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_REL * np.abs(vol).max())


@pytest.mark.parametrize("case", sorted(RESAMPLE_CASES))
def test_resample_int16_matches_jax(case):
    """int16 in, int16 out, by the module docstring's int16 rule."""
    shape, in_sp, out_sp, kw = RESAMPLE_CASES[case]
    vol = np.random.default_rng(8).integers(-1024, 1500, shape).astype(np.int16)
    got, want = _resample_pair(vol, in_sp, out_sp, kw)
    spatial = kw.get("spatial_dims", max(len(np.atleast_1d(in_sp)), len(np.atleast_1d(out_sp))))
    spatial = min(vol.ndim, 3) if spatial == 1 else spatial
    assert_int16_rule(got, want, exact_resample(vol, in_sp, out_sp, got.shape, spatial), case)


@pytest.mark.parametrize("case", ["3d_aniso", "2d_channels"])
def test_resample_nearest_matches_jax(case):
    """Nearest resampling (one tap per row) is exact."""
    shape, in_sp, out_sp, kw = RESAMPLE_CASES[case]
    vol = np.random.default_rng(9).integers(0, 2, shape).astype(np.int16)
    got, want = _resample_pair(vol, in_sp, out_sp, kw, method="nearest")
    assert np.array_equal(got, want)


def test_resampler_shape_and_device_rule():
    """``resample_output_shape`` is JAX's; the resampler defaults to the
    card and raises without one."""
    for args in (((512, 512, 256), (0.39, 0.39, 0.625), 0.5), ((7, 9), 1.0, (0.3, 2.0)), ((5, 5, 5), 1, 100)):
        assert port_rs.resample_output_shape(*args) == jax_rs.resample_output_shape(*args)
    assert port_rs.resample_output_shape((512, 512, 256), (0.39, 0.39, 0.625), 0.5) == (399, 399, 320)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            port_rs.resample_volume(np.zeros((4, 4, 4), np.int16), 1.0, 0.5)


# --- patients and the preprocess command ---------------------------------------


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_meta(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype and np.array_equal(g, w), k
        else:
            assert g == w, k


def _check_patient(got_path, want_path, scan_path, out_spacing):
    """Meta and mask bit-equal; the scan bit-equal at native spacing, by
    the int16 rule resampled."""
    got, gmeta = port_pre.load_patient(got_path)
    want, wmeta = jax_pre.load_patient(want_path)
    assert got.dtype == want.dtype == np.int16 and got.shape == want.shape
    _same_meta(gmeta, wmeta)
    assert np.array_equal(got[..., 1], want[..., 1]), "masks differ"
    if out_spacing is None:
        assert np.array_equal(got[..., 0], want[..., 0])
        return
    raw, meta = port_io.load_scan(scan_path)
    exact = exact_resample(raw, meta["spacing"], out_spacing, got.shape[:3], 3)
    assert_int16_rule(got[..., 0], want[..., 0], exact, Path(got_path).name)


@pytest.mark.parametrize("out_spacing", [None, 0.5, (0.6, 0.55, 0.9)])
def test_create_patient_matches_jax(tmp_path, rng, out_spacing):
    """One raw patient through both ``create_patient``s, at native spacing
    and resampled (isotropic and per-axis): the meta and the mask
    bit-equal, the scan bit-equal at native spacing and under the int16
    rule resampled."""
    root = _raw_cohort(tmp_path / "raw", rng, names=("pa",))
    args = (root / "pa.mhd", root / "pa", root / "pa" / "ostia.xml")
    want = jax_pre.create_patient(*args, tmp_path / "jax", out_spacing=out_spacing)
    got = port_pre.create_patient(*args, tmp_path / "port", out_spacing=out_spacing, device="cpu")
    assert got.name == want.name
    _check_patient(got, want, args[0], out_spacing)


@pytest.mark.parametrize("extra", [[], ["--out-spacing", "0.5"], ["--out-spacing", "0.6", "0.55", "0.9"]])
def test_preprocess_cli_matches_jax_script(tmp_path, rng, monkeypatch, extra):
    """A 2-patient raw cohort (plus a scan without its centerline folder,
    skipped by both) through ``preprocess.main`` and JAX's
    ``scripts/preprocess.py``: the same patients, each as
    :func:`test_create_patient_matches_jax` holds them."""
    root = _raw_cohort(tmp_path / "raw", rng)
    jax_io.write_mhd(np.zeros((4, 4, 4), np.int16), root / "orphan.mhd")
    monkeypatch.setattr(sys, "argv", ["preprocess.py", str(root), str(tmp_path / "jax"), *extra])
    _jax_script("preprocess").main()
    written = preprocess.main([str(root), str(tmp_path / "port"), *extra, "--device", "cpu"])
    assert [p.name for p in written] == ["pa.npy", "pb.npy"]
    assert sorted(p.name for p in (tmp_path / "jax").glob("*.npy")) == ["pa.npy", "pb.npy"]
    spacing = [float(v) for v in extra[1:]] or None
    for p in written:
        _check_patient(p, tmp_path / "jax" / p.name, root / f"{p.stem}.mhd", spacing)


def test_preprocess_cli_shard_picks_jax_scans(tmp_path, rng, monkeypatch):
    """``--shard i/n`` writes the scans JAX's ``--shard`` writes, and the
    shards partition the cohort."""
    root = _raw_cohort(tmp_path / "raw", rng, names=("pa", "pb", "pc"), shape=(12, 10, 8))
    mine = []
    for i in (0, 1):
        monkeypatch.setattr(sys, "argv", ["preprocess.py", str(root), str(tmp_path / f"jax{i}"), "--shard", f"{i}/2"])
        _jax_script("preprocess").main()
        got = preprocess.main([str(root), str(tmp_path / f"port{i}"), "--shard", f"{i}/2", "--device", "cpu"])
        assert sorted(p.name for p in got) == sorted(p.name for p in (tmp_path / f"jax{i}").glob("*.npy"))
        mine += [p.name for p in got]
    assert sorted(mine) == ["pa.npy", "pb.npy", "pc.npy"]


@pytest.mark.parametrize("argv", [["--format", "zarr"], ["--h5-chunks", "8", "8", "1", "2"], ["--shard", "2/2"],
                                  ["--out-spacing", "0.5", "0.5"]])
def test_preprocess_cli_usage_errors(tmp_path, argv):
    """An unknown format, HDF5 chunks for ``.npy`` patients (as the JAX
    script refuses them), a bad shard or spacing count. ``--format h5``
    was a usage error until HDF5 was ported; it is a format now
    (``test_create_patient_hdf5_not_ported``)."""
    with pytest.raises(SystemExit) as e:
        preprocess.main([str(tmp_path), str(tmp_path / "out"), *argv, "--device", "cpu"])
    assert e.value.code == 2


def test_create_patient_hdf5_not_ported(tmp_path, rng):
    """HDF5 patients raised until HDF5 was ported: ``fmt="h5"`` (a
    standalone ``pa.h5``, chunked as asked) and a ``.h5`` corpus out_dir
    (the member ``corpus.h5::pa``) now write what the JAX package writes
    from the same scan, read back equal to its ``.npy`` patient; so do the
    CLIs' ``--format h5 --h5-chunks`` and a corpus out_dir."""
    import h5py

    root = _raw_cohort(tmp_path / "raw", rng, names=("pa",), shape=(8, 8, 8))
    raw = (root / "pa.mhd", root / "pa", root / "pa" / "ostia.xml")
    want_npy = jax_pre.load_patient(jax_pre.create_patient(*raw, tmp_path / "jax"))
    for kw, address in ((dict(fmt="h5", h5_chunks=(8, 8, 1, 2)), "out/pa.h5"), (dict(), "corpus.h5::pa")):
        out = tmp_path / address.split("/")[0].split("::")[0]
        got = port_pre.create_patient(*raw, out, device="cpu", **kw)
        want = jax_pre.create_patient(*raw, tmp_path / "jax" / out.name, **kw)
        assert str(got) == str(tmp_path / address) and str(want).endswith(address.split("/")[-1])
        for data, meta in (port_pre.load_patient(got), jax_pre.load_patient(want)):
            np.testing.assert_array_equal(np.asarray(data), np.asarray(want_npy[0]))
            np.testing.assert_allclose(meta["centerlines_world"], want_npy[1]["centerlines_world"])
            assert meta["name"] == "pa"
    with h5py.File(tmp_path / "out" / "pa.h5", "r") as fd:
        assert fd["scan_and_mask"].chunks == (8, 8, 1, 2)
    got = preprocess.main([str(root), str(tmp_path / "cli"), "--format", "h5", "--h5-chunks", "8", "8", "1", "2",
                           "--device", "cpu"])
    assert [str(p) for p in got] == [str(tmp_path / "cli" / "pa.h5")]
    got = preprocess.main([str(root), str(tmp_path / "cli" / "corpus.h5"), "--device", "cpu"])
    assert got == [f"{tmp_path / 'cli' / 'corpus.h5'}::pa"]


def test_preprocess_cli_logs_a_failing_scan_and_goes_on(tmp_path, rng):
    """A scan whose centerline file is unreadable fails alone, as in JAX."""
    root = _raw_cohort(tmp_path / "raw", rng, shape=(10, 10, 8))
    (root / "pa" / "vessel0.txt").write_text("not numbers\n")
    written = preprocess.main([str(root), str(tmp_path / "out"), "--device", "cpu"])
    assert [p.name for p in written] == ["pb.npy"]
    with open(tmp_path / "out" / "pb_meta.pkl", "rb") as fd:
        assert pickle.load(fd)["name"] == "pb"
