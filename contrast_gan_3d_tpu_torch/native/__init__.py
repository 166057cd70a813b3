"""The host data ops in C++ (the port's copy of ``contrast_gan_3d_tpu/native``):
the sampler's zero-filled crop, the fused affine + elastic warp of the 3D
host augmentation and the 2D family's rotate + mirror slice warp, which run
in the loaders' worker threads, and the geometry engine's trilinear
interpolation.

``csrc/hostops.cpp`` (a verbatim copy of the JAX package's source) is
compiled at first use with ``g++ -O3 -march=native -shared -fPIC -fopenmp``
into ``build/torch_native/`` at the root of the checkout and loaded with
``ctypes.CDLL``, which releases the GIL for the length of a call: the
loaders' workers warp while the dispatching thread runs. The library's file
name carries the hash of the source and of the host CPU's feature flags,
because ``-march=native`` code built on one host may not run on another.
Where the compiler has no OpenMP the build is retried without
``-fopenmp`` and :func:`warp_num_threads` reports 1. A failed build raises
with the compiler's output; nothing falls back to another warp.

Bound: ``crop_pad_int16``, ``warp_augment_int16``, ``warp_augment2d_int16``,
``warp_num_threads`` and ``trilinear_f32``.
"""

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "hostops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_LIB: Optional[ctypes.CDLL] = None
# the loaders' worker threads reach the first call together: one builds,
# the others wait for the published library
_BUILD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def cpu_isa_tag() -> str:
    """A fingerprint of the host CPU's feature flags (the ``flags`` line of
    /proc/cpuinfo; the platform's name elsewhere)."""
    try:
        with open("/proc/cpuinfo") as fd:
            for line in fd:
                if line.startswith(("flags", "Features")):
                    flags = " ".join(sorted(line.split(":", 1)[1].split()))
                    return hashlib.sha1(flags.encode()).hexdigest()[:8]
    except OSError:
        pass
    return f"{platform.machine()}-{platform.processor()}"


def library_path() -> Path:
    tag = hashlib.sha1(SRC.read_bytes() + cpu_isa_tag().encode()).hexdigest()[:12]
    return BUILD_DIR / f"hostops_{tag}.so"


def build_log_path() -> Path:
    """The compiler command and output of the library's build."""
    return library_path().with_suffix(".log")


def _compile(so_path: Path) -> None:
    """Compile ``SRC`` into ``so_path`` (with OpenMP, else without);
    RuntimeError with the compiler's output when neither build succeeds."""
    so_path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=so_path.parent, prefix=f"{so_path.stem}.", suffix=".tmp.so")
    os.close(fd)
    log = []
    try:
        for extra in (("-fopenmp",), ()):
            cmd = [CXX, *CXX_FLAGS, *extra, str(SRC), "-o", tmp]
            try:
                res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            except OSError as e:  # no compiler at all
                raise RuntimeError(f"native hostops build failed: cannot run {CXX!r}: {e}") from e
            log.append(f"$ {' '.join(cmd)}\n{res.stdout}exit {res.returncode}\n")
            if res.returncode == 0:
                so_path.with_suffix(".log").write_text("".join(log))
                os.replace(tmp, so_path)  # atomic: no half-written library
                return
        raise RuntimeError("native hostops build failed:\n" + "".join(log))
    finally:
        Path(tmp).unlink(missing_ok=True)


def load() -> ctypes.CDLL:
    """The bound library, built first if this host has none."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _BUILD_LOCK:
        if _LIB is None:
            so_path = library_path()
            if not so_path.exists():
                _compile(so_path)
            lib = ctypes.CDLL(str(so_path))
            lib.crop_pad_int16.restype = ctypes.c_long
            lib.crop_pad_int16.argtypes = [ctypes.c_void_p, *([ctypes.c_long] * 10), ctypes.c_void_p]
            lib.warp_num_threads.restype = ctypes.c_long
            lib.warp_num_threads.argtypes = []
            lib.warp_augment_int16.restype = None
            lib.warp_augment_int16.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_long, ctypes.c_long, ctypes.c_long,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.trilinear_f32.restype = None
            lib.trilinear_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
            ]
            lib.warp_augment2d_int16.restype = None
            lib.warp_augment2d_int16.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_long, ctypes.c_long,
                ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
            _LIB = lib
    return _LIB


def build_info() -> dict:
    """The library's path, the compiler's version, whether it was built
    with ``-fopenmp``, ``warp_num_threads()`` and the host's core count."""
    load()
    log = build_log_path().read_text() if build_log_path().exists() else ""
    last_cmd = [line for line in log.splitlines() if line.startswith("$ ")][-1:] or [""]
    try:
        version = subprocess.run([CXX, "--version"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True).stdout.splitlines()[:1]
    except OSError:  # a library built earlier, no compiler now
        version = []
    return {"library": str(library_path()), "cxx": version[0] if version else CXX,
            "openmp": "-fopenmp" in last_cmd[0], "warp_num_threads": warp_num_threads(),
            "nproc": os.cpu_count()}


def warp_num_threads() -> int:
    """Host threads one warp call slab-splits across (OpenMP, honouring
    ``OMP_NUM_THREADS``); 1 for a library built without OpenMP."""
    return int(load().warp_num_threads())


def crop_pad_int16_reference(volume, start, patch_size) -> np.ndarray:
    """The plain version of :func:`crop_pad_int16`: one numpy slice of the
    window clipped to the volume, copied into zeros (a windowed read on
    any sliceable array)."""
    px, py, pz = (int(p) for p in patch_size)
    out = np.zeros((px, py, pz, volume.shape[3]), np.int16)
    src_sl, dst_sl = [], []
    for s, p, dim in zip(start, (px, py, pz), volume.shape[:3]):
        lo, hi = max(0, int(s)), min(dim, int(s) + p)
        src_sl.append(slice(lo, hi))
        dst_sl.append(slice(lo - int(s), lo - int(s) + max(0, hi - lo)))
    if all(sl.stop > sl.start for sl in src_sl):
        out[tuple(dst_sl)] = volume[tuple(src_sl)]
    return out


def crop_pad_int16(volume: np.ndarray, start, patch_size, out: Optional[np.ndarray] = None) -> np.ndarray:
    """A zero-padded (px, py, pz, C) window of the (W, H, D, C) int16
    ``volume`` whose ``start`` may be negative or overhang it. Only the
    window's rows are read: a C-contiguous ndarray goes through the C crop
    (on a memmap only the window's pages fault in); any other sliceable
    array (an h5py dataset, a strided view) through one windowed read of
    the clipped window (on an h5py dataset only the chunks it touches)."""
    if not (volume.ndim == 4 and volume.dtype == np.int16):
        raise ValueError(f"crop_pad_int16 takes a (W, H, D, C) int16 array, not {volume.dtype} {volume.shape}")
    px, py, pz = (int(p) for p in patch_size)
    C = volume.shape[3]
    if out is None:
        out = np.empty((px, py, pz, C), np.int16)
    elif not (out.shape == (px, py, pz, C) and out.dtype == np.int16 and out.flags["C_CONTIGUOUS"]):
        # the C code memsets and writes px*py*pz*C int16s through out's
        # pointer: a wrong buffer would be heap corruption, not an error
        raise ValueError(f"out must be a C-contiguous int16 array of shape {(px, py, pz, C)}")
    if not (isinstance(volume, np.ndarray) and volume.flags["C_CONTIGUOUS"]):
        out[...] = crop_pad_int16_reference(volume, start, patch_size)
        return out
    load().crop_pad_int16(volume.ctypes.data, *(int(d) for d in volume.shape),
                          int(start[0]), int(start[1]), int(start[2]), px, py, pz, out.ctypes.data)
    return out


def warp_augment_int16(scan: np.ndarray, seg: np.ndarray, affine: np.ndarray,
                       coarse_field: Optional[np.ndarray] = None, amplitude: Optional[np.ndarray] = None):
    """The fused warp of one (W, H, D) int16 scan and mask pair: ``src = A @
    (dst - c) + c + amp * elastic(dst)``, the elastic field a half-pixel
    linear upsample of the (G, G, G, 3) ``coarse_field``; the scan
    trilinear, rounded as floor(v + 0.5), the mask nearest (half to even),
    both clamped to the edge. Counts its calls in
    ``warp_augment_int16.calls``."""
    lib = load()
    scan = np.ascontiguousarray(scan, np.int16)
    seg = np.ascontiguousarray(seg, np.int16)
    affine = np.ascontiguousarray(affine, np.float32)
    if affine.shape != (3, 3) or scan.ndim != 3 or seg.shape != scan.shape:
        raise ValueError(f"warp_augment_int16: scan {scan.shape}, seg {seg.shape}, affine {affine.shape}")
    out_scan, out_seg = np.empty_like(scan), np.empty_like(seg)
    if coarse_field is not None:
        coarse_field = np.ascontiguousarray(coarse_field, np.float32)
        G = coarse_field.shape[0]
        amp = np.ascontiguousarray(amplitude, np.float32)
        if coarse_field.shape != (G, G, G, 3) or amp.shape != (3,):
            raise ValueError(f"warp_augment_int16: coarse field {coarse_field.shape}, amplitude {amp.shape}")
        cf_ptr, amp_ptr = coarse_field.ctypes.data, amp.ctypes.data
    else:
        G, cf_ptr, amp_ptr = 0, None, None
    lib.warp_augment_int16(scan.ctypes.data, seg.ctypes.data, *(int(d) for d in scan.shape),
                           affine.ctypes.data, cf_ptr, G, amp_ptr, out_scan.ctypes.data, out_seg.ctypes.data)
    with _COUNT_LOCK:
        warp_augment_int16.calls += 1
    return out_scan, out_seg


warp_augment_int16.calls = 0


def warp_augment2d_int16(scan: np.ndarray, seg: np.ndarray, affine: np.ndarray):
    """The 2D warp of one (W, H) int16 slice and mask pair: ``src = A @ (dst
    - c) + c`` (a rotation with the mirror folded into the 2x2 ``A``); the
    scan bilinear, rounded as floor(v + 0.5), the mask nearest (half to
    even), both clamped to the edge, as ``ops/resample.bilinear_sample`` /
    ``nearest_sample_2d``. Counts its calls in
    ``warp_augment2d_int16.calls``."""
    lib = load()
    scan = np.ascontiguousarray(scan, np.int16)
    seg = np.ascontiguousarray(seg, np.int16)
    affine = np.ascontiguousarray(affine, np.float32)
    if affine.shape != (2, 2) or scan.ndim != 2 or seg.shape != scan.shape:
        raise ValueError(f"warp_augment2d_int16: scan {scan.shape}, seg {seg.shape}, affine {affine.shape}")
    out_scan, out_seg = np.empty_like(scan), np.empty_like(seg)
    lib.warp_augment2d_int16(scan.ctypes.data, seg.ctypes.data, *(int(d) for d in scan.shape),
                             affine.ctypes.data, out_scan.ctypes.data, out_seg.ctypes.data)
    with _COUNT_LOCK:
        warp_augment2d_int16.calls += 1
    return out_scan, out_seg


warp_augment2d_int16.calls = 0


def trilinear_f32(volume: np.ndarray, xs: np.ndarray, ys: np.ndarray, zs: np.ndarray) -> np.ndarray:
    """Trilinear samples of a (W, H, D) volume, as f32, at the fractional
    voxel coordinates ``xs``, ``ys``, ``zs`` (flattened): the native
    ``utils/geometry.trilinear_interpolate`` (truncated base, the +1
    neighbour clipped on its own, extrapolating near the border)."""
    lib = load()
    vol = np.ascontiguousarray(volume, dtype=np.float32)
    if vol.ndim != 3:
        raise ValueError(f"trilinear_f32 takes a (W, H, D) volume, got {vol.shape}")
    xs, ys, zs = (np.ascontiguousarray(c, dtype=np.float32).ravel() for c in (xs, ys, zs))
    if not xs.shape == ys.shape == zs.shape:
        raise ValueError(f"trilinear_f32: coordinate counts {xs.shape}, {ys.shape}, {zs.shape}")
    out = np.empty(xs.shape, np.float32)
    lib.trilinear_f32(vol.ctypes.data, *(int(d) for d in vol.shape), xs.ctypes.data, ys.ctypes.data,
                      zs.ctypes.data, len(xs), out.ctypes.data)
    return out
