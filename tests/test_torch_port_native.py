"""The port's native host ops (``contrast_gan_3d_tpu_torch/native``) vs the
JAX package's, on the CPU.

Tolerances, and why:
- the native warp and crop against ``contrast_gan_3d_tpu.native``:
  bit-identical (the same C++ source, built with the same flags on the same
  host), on the shapes and transforms ``tests/test_host_augment.py`` uses,
  odd sizes and half-integer coordinates included;
- sampler batches through the port's ``HostAugmenter`` against the JAX
  sampler with its ``HostAugmenter``, one seed: bit-identical;
- the native warp against its plain version (``host_augment.warp_int16``,
  the port's samplers on CPU tensors): every voxel within 1 HU and at least
  99.9% of voxels equal, for the scan and for the mask (float coordinates
  computed in another order round differently near .5).
"""

import os
import sys
import threading

import numpy as np
import pytest

from contrast_gan_3d_tpu import native as jax_native
from contrast_gan_3d_tpu.data.host_augment import HostAugmenter as JaxHostAugmenter
from contrast_gan_3d_tpu.data.sampler import CCTAPatchSampler as JaxSampler
from contrast_gan_3d_tpu_torch import native
from contrast_gan_3d_tpu_torch.data import augment as aug
from contrast_gan_3d_tpu_torch.data.host_augment import HostAugmenter, rotation_matrix_np, warp_int16
from contrast_gan_3d_tpu_torch.data.sampler import CCTAPatchSampler, crop_pad_int16, crop_pad_int16_reference
from tests.test_torch_port_fit import fold  # noqa: F401  (the fixture)

ROTATION = rotation_matrix_np(np.array([0.3, -0.2, 0.5]))


def _case(name, rng):
    """(scan, seg, affine, coarse, amp) of one of test_host_augment.py's
    cases."""
    shapes = {"identity": (12, 12, 12), "rotation": (12, 12, 12), "scale": (12, 12, 12),
              "elastic_constant": (12, 12, 12), "elastic_random": (12, 12, 12), "half_integer": (8, 8, 8),
              "odd_5x4x3": (5, 4, 3), "odd_2x2x2": (2, 2, 2), "odd_17x3x9": (17, 3, 9), "odd_16x16x5": (16, 16, 5),
              "combined_16": (16, 16, 16), "combined_32": (32, 32, 32)}
    shape = shapes[name]
    scan = rng.integers(-500, 500, shape).astype(np.int16)
    seg = (rng.integers(0, 5, shape) if name == "half_integer" else rng.random(shape) < 0.1).astype(np.int16)
    coarse = amp = None
    affine = np.eye(3, dtype=np.float32)
    if name == "rotation":
        affine = ROTATION
    elif name == "scale":
        affine = np.eye(3) * 1.3
    elif name == "elastic_constant":
        coarse, amp = np.ones((4, 4, 4, 3), np.float32), np.array([2.0, 0.0, 0.0], np.float32)
    elif name == "elastic_random":
        coarse = rng.uniform(-1.0, 1.0, (4, 4, 4, 3)).astype(np.float32)
        amp = np.array([2.5, 1.5, 3.0], np.float32)
    elif name == "half_integer":  # an exact 2x downscale: every coordinate on a half-integer
        affine = np.eye(3) * 2.0
    elif name.startswith("odd"):
        affine = rotation_matrix_np(np.array([0.4, -0.5, 0.2])) * 1.1
    elif name.startswith("combined"):
        affine = ROTATION * 1.2
        coarse = rng.uniform(-1, 1, (8, 8, 8, 3)).astype(np.float32)
        amp = np.array([2.0, 1.0, 3.0], np.float32)
    return scan, seg, np.asarray(affine, np.float32), coarse, amp


CASES = ["identity", "rotation", "scale", "elastic_constant", "elastic_random", "half_integer", "odd_5x4x3",
         "odd_2x2x2", "odd_17x3x9", "odd_16x16x5", "combined_16", "combined_32"]


@pytest.mark.parametrize("name", CASES)
def test_warp_bit_identical_to_jax_native(rng, name):
    scan, seg, affine, coarse, amp = _case(name, rng)
    got = native.warp_augment_int16(scan, seg, affine, coarse, amp)
    want = jax_native.warp_augment_int16(scan, seg, affine, coarse, amp)
    for g, w in zip(got, want):
        assert g.dtype == np.int16 and g.shape == scan.shape
        np.testing.assert_array_equal(g, w)
    if name == "identity":
        np.testing.assert_array_equal(got[0], scan)
        np.testing.assert_array_equal(got[1], seg)


@pytest.mark.parametrize("start", [(0, 0, 0), (-3, 2, -5), (4, -2, 3), (10, 9, 8), (-20, 0, 0), (3, 1, 2)])
def test_crop_bit_identical_to_jax_native(rng, tmp_path, start):
    """Inside, overhanging on either side and fully outside the volume; an
    ndarray and a memmap of it."""
    vol = rng.integers(-1024, 1500, (12, 10, 9, 2)).astype(np.int16)
    np.save(tmp_path / "v.npy", vol)
    mm = np.load(tmp_path / "v.npy", mmap_mode="r")
    want = jax_native.crop_pad_int16(vol, start, (6, 7, 5))
    for volume in (vol, mm):
        np.testing.assert_array_equal(native.crop_pad_int16(volume, start, (6, 7, 5)), want)
        np.testing.assert_array_equal(crop_pad_int16(volume, start, (6, 7, 5)), want)
    np.testing.assert_array_equal(crop_pad_int16_reference(vol, start, (6, 7, 5)), want)
    # a non-contiguous view takes the windowed read
    view = np.asfortranarray(vol)
    np.testing.assert_array_equal(crop_pad_int16(view, start, (6, 7, 5)), want)


def test_crop_refuses_a_wrong_buffer(rng):
    vol = rng.integers(-10, 10, (5, 5, 5, 2)).astype(np.int16)
    for out in (np.empty((4, 4, 4, 2), np.int32), np.empty((4, 4, 3, 2), np.int16),
                np.empty((4, 4, 4, 2), np.int16, order="F")):
        with pytest.raises(ValueError, match="out must be"):
            native.crop_pad_int16(vol, (0, 0, 0), (4, 4, 4), out=out)
    # a volume that is not a C-contiguous ndarray (here a Fortran-order
    # copy; an HDF5 patient's h5py dataset) is cropped by a windowed read,
    # as in the JAX package, where it raised before HDF5 was ported; a
    # wrong dtype or rank is refused
    np.testing.assert_array_equal(native.crop_pad_int16(np.asfortranarray(vol), (0, 0, 0), (4, 4, 4)),
                                  crop_pad_int16_reference(vol, (0, 0, 0), (4, 4, 4)))
    for bad in (vol.astype(np.int32), vol[..., 0]):
        with pytest.raises(ValueError, match="int16 array"):
            native.crop_pad_int16(bad, (0, 0, 0), (4, 4, 4))
    out = np.full((4, 4, 4, 2), 7, np.int16)
    assert native.crop_pad_int16(vol, (2, 2, 2), (4, 4, 4), out=out) is out
    np.testing.assert_array_equal(out, crop_pad_int16_reference(vol, (2, 2, 2), (4, 4, 4)))


def test_sampler_batches_with_host_augmenter_bit_identical_to_jax(fold):  # noqa: F811
    """One seed: the port's sampler with its HostAugmenter against the JAX
    sampler with its HostAugmenter, every transform likely. The port's
    batches go through the native warp, never the plain one."""
    paths = [p for p, _ in fold]
    kw = dict(p_elastic=0.7, p_scale=0.7, p_rotation=0.7, elastic_grid=4)
    from contrast_gan_3d_tpu.data.augment import AugmentConfig as JaxAugmentConfig

    js = JaxSampler(paths, (16, 16, 16), 3, rng=np.random.default_rng(4),
                    augmenter=JaxHostAugmenter(JaxAugmentConfig(**kw), np.random.default_rng(9)))
    ps = CCTAPatchSampler(paths, (16, 16, 16), 3, rng=np.random.default_rng(4),
                          augmenter=HostAugmenter(aug.AugmentConfig(**kw), np.random.default_rng(9)))
    calls, plain_calls = native.warp_augment_int16.calls, warp_int16.calls
    for _ in range(5):
        jb, pb = js.next_batch(), ps.next_batch()
        for k in ("data", "seg"):
            assert pb[k].dtype == np.int16
            np.testing.assert_array_equal(pb[k], jb[k])
    assert native.warp_augment_int16.calls - calls >= 5
    assert warp_int16.calls == plain_calls
    assert ps.augmenter.rng.bit_generator.state == js.augmenter.rng.bit_generator.state


@pytest.mark.parametrize("shape", [(24, 20, 16), (9, 12, 7), (32, 32, 32)])
def test_native_warp_against_its_plain_version(rng, shape):
    """Transforms drawn by the HostAugmenter, every gate open."""
    augmenter = HostAugmenter(aug.AugmentConfig(p_elastic=1.0, p_scale=1.0, p_rotation=1.0, elastic_grid=4),
                              np.random.default_rng(3))
    x = np.linspace(-1, 1, shape[0])[:, None, None]
    base = 800 * np.sin(4 * x) * np.cos(np.linspace(0, 3, shape[1]))[None, :, None]
    n = equal = seg_equal = 0
    for _ in range(6):
        scan = (base + rng.normal(0, 20, shape)).astype(np.int16)
        seg = (rng.random(shape) < 0.3).astype(np.int16)
        affine, coarse, amp, _ = augmenter.sample_params(shape)
        got = native.warp_augment_int16(scan, seg, affine, coarse, amp)
        want = warp_int16(scan, seg, affine, coarse, amp)
        assert np.abs(got[0].astype(np.int32) - want[0]).max() <= 1
        n += scan.size
        equal += int((got[0] == want[0]).sum())
        seg_equal += int((got[1] == want[1]).sum())
    assert equal / n >= 0.999, equal / n
    assert seg_equal / n >= 0.999, seg_equal / n


@pytest.mark.parametrize("cxx", ["/nonexistent/bin/g++", "false"])
def test_a_failed_build_raises(monkeypatch, tmp_path, cxx):
    """A missing compiler, and a compiler that fails: RuntimeError, no
    library, no fallback."""
    monkeypatch.setattr(native, "CXX", cxx)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="native hostops build failed"):
        native.warp_augment_int16(np.zeros((2, 2, 2), np.int16), np.zeros((2, 2, 2), np.int16), np.eye(3))
    assert not list(tmp_path.glob("*.so"))


def test_first_use_from_many_threads_builds_once(monkeypatch, tmp_path):
    """The loaders' workers reach the first call together: one build, one
    library for all of them."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_LIB", None)
    builds, real = [], native._compile

    def counted(so_path):
        builds.append(so_path)
        real(so_path)

    monkeypatch.setattr(native, "_compile", counted)
    libs, barrier = [], threading.Barrier(4)

    def first_call():
        barrier.wait()
        libs.append(native.load())

    threads = [threading.Thread(target=first_call) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert len(builds) == 1 and len(libs) == 4 and all(lib is libs[0] for lib in libs)
    assert native.library_path().parent == tmp_path and native.build_log_path().exists()


def test_concurrent_warps_from_more_threads_than_cores(rng):
    """The loaders' workers warp at once (ctypes releases the GIL): each
    call's result equals the serial one and no call goes uncounted."""
    cases = [_case(name, rng) for name in ("combined_16", "odd_17x3x9", "elastic_random", "rotation")]
    want = [native.warp_augment_int16(*c) for c in cases]
    n_threads, reps = 2 * (os.cpu_count() or 1) + 1, 6
    calls, bad = native.warp_augment_int16.calls, []

    def worker(i):
        for r in range(reps):
            got = native.warp_augment_int16(*cases[(i + r) % len(cases)])
            w = want[(i + r) % len(cases)]
            if not (np.array_equal(got[0], w[0]) and np.array_equal(got[1], w[1])):
                bad.append((i, r))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert not bad and native.warp_augment_int16.calls - calls == n_threads * reps


def test_library_name_carries_the_source_and_the_cpu(monkeypatch):
    here = native.library_path()
    assert here.parent == native.BUILD_DIR and here.suffix == ".so"
    monkeypatch.setattr(native, "cpu_isa_tag", lambda: "another-cpu")
    assert native.library_path() != here


def test_build_info():
    info = native.build_info()
    assert info["warp_num_threads"] >= 1 and info["nproc"] >= 1
    assert isinstance(info["openmp"], bool) and info["library"].endswith(".so")
    assert native.warp_num_threads() == jax_native.warp_num_threads()
