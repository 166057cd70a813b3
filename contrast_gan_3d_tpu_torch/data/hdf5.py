"""HDF5 patient storage: standalone files and corpus files (the port's copy
of ``contrast_gan_3d_tpu/data/hdf5.py``, byte-compatible with it: the same
datasets, chunks and attributes, so either package reads the other's
files).

A patient is the packed ``(W, H, D, 2)`` int16 array (scan, centerline
mask) of ``data/preprocess.write_patient``, in HDF5:

- **standalone**: one ``<name>.h5`` per patient (in place of ``.npy``);
- **corpus**: many patients as groups of one ``corpus.h5`` file, addressed
  as ``corpus.h5::<name>`` wherever a patient path is taken (fold lists,
  ``load_patient``, the samplers). A corpus file is the unit a multi-host
  run shards: each host reads only its members
  (``parallel/multihost.host_fold_shard``).

Reads stay windowed: an h5py dataset slices like a memmap, so a random crop
reads only the chunks it touches (64^3 spatial chunks by default). The
metadata that the ``.npy`` layout pickles lives in HDF5 attributes and
datasets, so a corpus file is self-contained.

h5py is imported where a file is opened, never when this module is: the
card's machine has no h5py, and there an ``.h5`` path raises
``ImportError`` naming it while the ``.npy`` path runs. h5py serialises
libhdf5 calls behind one lock, so the loaders' threads may read one file
concurrently.
"""

import logging
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

logger = logging.getLogger(__name__)

PathLike = Union[str, Path]

#: separator between a corpus file and a member name: ``corpus.h5::patient``
MEMBER_SEP = "::"
#: dataset holding the packed (W, H, D, 2) int16 scan and mask
SCAN_DS = "scan_and_mask"
#: metadata arrays kept as datasets rather than attributes
_META_DATASETS = ("centerlines_world", "ostia_world")
_H5_SUFFIXES = (".h5", ".hdf5")


def h5py_module():
    """The h5py module, imported now; ``ImportError`` naming h5py where it
    is missing (as on the card's machine)."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("h5py is required for HDF5 patients and scans (.h5 paths), and it cannot be imported "
                          "here; use the .npy format or install h5py") from e
    return h5py


def split_member(path: PathLike) -> Tuple[str, Optional[str]]:
    """``'corpus.h5::name'`` -> ``('corpus.h5', 'name')``; a plain path
    passes through with member None."""
    text = str(path)
    if MEMBER_SEP in text:
        file_part, member = text.split(MEMBER_SEP, 1)
        return file_part, member or None
    return text, None


def is_hdf5_path(path: PathLike) -> bool:
    """True for ``*.h5`` / ``*.hdf5`` files (any case) and ``file.h5::member``
    addresses."""
    file_part, _ = split_member(path)
    return file_part.lower().endswith(_H5_SUFFIXES)


def _chunk_shape(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """64^3 spatial chunks by every trailing dim: a random 128^3 crop
    touches at most 3^3 chunks."""
    return tuple(min(int(s), 64) for s in shape[:3]) + tuple(int(s) for s in shape[3:])


def _write_meta(node, meta: Dict, compression: Optional[str]):
    for key in _META_DATASETS:
        if key in meta and meta[key] is not None:
            node.create_dataset(key, data=np.asarray(meta[key], np.float64), compression=compression)
    for key, value in meta.items():
        if key in _META_DATASETS:
            continue
        try:
            node.attrs[key] = value
        except TypeError:
            logger.warning("HDF5 patient meta: dropping unserializable key %r (%s)", key, type(value).__name__)


def _read_meta(node) -> Dict:
    meta: Dict = {}
    for key, value in node.attrs.items():
        if isinstance(value, bytes):
            value = value.decode("utf-8", errors="replace")
        elif isinstance(value, np.generic):
            value = value.item()
        meta[key] = value
    for key in _META_DATASETS:
        if key in node:
            meta[key] = np.asarray(node[key])
    return meta


def write_patient_h5(volume: np.ndarray, centerlines_mask: np.ndarray, meta: Dict, name: str, out: PathLike,
                     compression: Optional[str] = None, chunks: Optional[Tuple[int, ...]] = None) -> str:
    """Write one patient. ``out`` is a directory (a standalone
    ``<out>/<name>.h5``) or a ``.h5`` corpus file that takes the patient as
    group ``name`` (the file is made if missing, the group replaced if
    present). Returns the patient's address (``file.h5`` or
    ``file.h5::name``).

    ``compression``: an h5py filter (``"gzip"``, ``"lzf"``); uncompressed
    by default, for the random crops' read speed. ``chunks``: the storage
    chunk shape (default 64^3 spatial chunks; a corpus for the 2D slice
    samplers wants z-thin ones, e.g. ``(64, 64, 1, 2)``). A corpus file has
    one writer at a time (HDF5 has no concurrent writers): parallel
    preprocessing jobs write one corpus file each."""
    h5py = h5py_module()
    scan_and_mask = np.stack([np.asarray(volume, np.int16), np.asarray(centerlines_mask, np.int16)], axis=-1)
    meta = dict(meta) | {"name": name}
    out = Path(out)
    if out.suffix.lower() in _H5_SUFFIXES:
        out.parent.mkdir(parents=True, exist_ok=True)
        with h5py.File(out, "a") as fd:
            if name in fd:
                del fd[name]
            group = fd.create_group(name)
            group.create_dataset(SCAN_DS, data=scan_and_mask, chunks=chunks or _chunk_shape(scan_and_mask.shape),
                                 compression=compression)
            _write_meta(group, meta, compression)
        return f"{out}{MEMBER_SEP}{name}"
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{name}.h5"
    with h5py.File(path, "w") as fd:
        fd.create_dataset(SCAN_DS, data=scan_and_mask, chunks=chunks or _chunk_shape(scan_and_mask.shape),
                          compression=compression)
        _write_meta(fd, meta, compression)
    return str(path)


def open_patient_h5(path: PathLike, file_cache: Optional[Dict] = None) -> Tuple[object, Dict]:
    """A patient for windowed reads: ((W, H, D, 2) h5py dataset, meta). The
    dataset slices like the ``.npy`` memmap and reads only the chunks a
    slice touches; it keeps its file open for as long as it lives.

    ``file_cache`` ({file path: h5py.File}) shares one file descriptor
    among the members of a corpus file: a sampler over every member of a
    large corpus would otherwise hold one descriptor per patient. The
    caller owns the cached files for its lifetime. A member that is not
    there raises ``KeyError`` naming the members there are, and leaves a
    cached file open for the others."""
    h5py = h5py_module()
    file_part, member = split_member(path)
    cached = file_cache is not None
    if cached:
        fd = file_cache.get(file_part)
        if fd is None:
            fd = h5py.File(file_part, "r")
            kept = file_cache.setdefault(file_part, fd)
            if kept is not fd:  # another thread opened it first: keep one
                fd.close()
                fd = kept
    else:
        fd = h5py.File(file_part, "r")
    try:
        node = fd[member] if member is not None else fd
        data = node[SCAN_DS]
        meta = _read_meta(node)
    except KeyError:
        available = f"; members: {sorted(fd.keys())[:16]}"
        if not cached:
            fd.close()
        raise KeyError(f"{path}: no patient data found (member={member!r}, dataset={SCAN_DS!r}){available}") from None
    return data, meta


def corpus_members(path: PathLike) -> List[str]:
    """The patients' addresses (``file.h5::name``) in a corpus file, sorted
    by name; a standalone patient file or a member address returns
    itself."""
    h5py = h5py_module()
    file_part, member = split_member(path)
    if member is not None:
        return [str(path)]
    with h5py.File(file_part, "r") as fd:
        if SCAN_DS in fd:
            return [str(path)]  # a standalone patient
        return [f"{file_part}{MEMBER_SEP}{name}" for name in sorted(fd.keys())
                if isinstance(fd[name], h5py.Group) and SCAN_DS in fd[name]]


def shard_members(members: List[str], shard_index: int, shard_count: int) -> List[str]:
    """Shard ``shard_index`` of ``shard_count`` of a member list:
    ``members[i::n]``, the same on every host."""
    if not 0 <= shard_index < shard_count:
        raise ValueError(f"shard {shard_index} of {shard_count}")
    return list(members[shard_index::shard_count])
