"""Random patch sampling from memory-mapped patients (counterpart of
``CCTAPatchSampler`` in ``contrast_gan_3d_tpu/data/sampler.py``).

Per 3D sample: a patient from a shuffled epoch order, a random crop of the
(virtually) centre-padded scan and mask, or with ``p_centerline_3d`` a crop
centred on a random centerline point, then the optional host augmenter.
Per 2D sample (a 2-element patch shape, the 2D family): half the time the
axial slice through a random centerline point, centre-padded to the patch
and cropped around the point; otherwise a random slice, padded, randomly
cropped (reference ``CCTADataLoader.py:51-69``).
With the same files and the same ``np.random.Generator`` seed the batches
are bit-identical to the JAX sampler's: the draws are the same calls in
the same order, and the 3D crop is the native crop the JAX package calls.
Patches stay int16; the scaler runs in the train step.
"""

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from contrast_gan_3d_tpu_torch.native import crop_pad_int16, crop_pad_int16_reference  # noqa: F401
from contrast_gan_3d_tpu_torch.data.preprocess import load_patient
from contrast_gan_3d_tpu_torch.utils import geometry as geom


def _pad_to(volume: np.ndarray, target: Sequence[int]) -> np.ndarray:
    """Centre-pad the leading len(target) dims up to ``target`` with zeros."""
    pads = []
    for i, t in enumerate(target):
        missing = max(0, t - volume.shape[i])
        pads.append((missing // 2, missing - missing // 2))
    pads += [(0, 0)] * (volume.ndim - len(target))
    if any(p != (0, 0) for p in pads):
        volume = np.pad(volume, pads)
    return volume


class CCTAPatchSampler:
    """Random 3D or 2D patch sampler over one ScanType's patient list;
    infinite, or one pass (``infinite=False``, the last batch may be
    short)."""

    def __init__(
        self,
        paths: List[str],
        patch_shape: Sequence[int],
        batch_size: int,
        rng: Optional[np.random.Generator] = None,
        shuffle: bool = True,
        infinite: bool = True,
        augmenter=None,  # HostAugmenter (3D) or HostAugmenter2D
        p_centerline_3d: float = 0.0,
    ):
        if not paths:
            raise ValueError("empty patient list")
        self.paths = list(paths)
        self._path_strs = [str(p) for p in self.paths]
        self.patch_shape = tuple(int(p) for p in patch_shape)
        if len(self.patch_shape) not in (2, 3):
            raise ValueError(f"patch_shape must have 2 or 3 dims, got {self.patch_shape}")
        self.is_2d = len(self.patch_shape) == 2
        self.batch_size = int(batch_size)
        self.p_centerline_3d = float(p_centerline_3d)
        self.rng = rng or np.random.default_rng()
        self.shuffle = shuffle
        self.infinite = infinite
        self.augmenter = augmenter
        self._order: List[int] = []
        self._epoch_done = False
        # np.random.Generator is not thread-safe and the loader's workers
        # sample concurrently: every draw goes through this lock
        self._rng_lock = threading.Lock()
        self._patients: Dict[str, tuple] = {}
        self._patients_lock = threading.Lock()
        # one h5py file per HDF5 corpus file, shared by its members
        # (data/hdf5.open_patient_h5): not one descriptor per patient
        self._h5_files: Dict[str, object] = {}

    def __len__(self) -> int:
        return len(self.paths)

    # -- resumable data stream (checkpointed beside the model) -------------
    def get_state(self) -> Dict:
        """The stream's rng, epoch order and patient list (and the
        augmenter's rng): :meth:`set_state` replays the batches from here."""
        with self._rng_lock:
            state = {
                "rng": self.rng.bit_generator.state,
                "order": list(self._order),
                "epoch_done": self._epoch_done,
                "paths": list(self._path_strs),
            }
            if self.augmenter is not None:
                state["augmenter_rng"] = self.augmenter.rng.bit_generator.state
        return state

    def set_state(self, state: Dict):
        """Restore a :meth:`get_state` snapshot; ValueError when it was saved
        for another patient list."""
        saved_paths = state.get("paths")
        if saved_paths is not None and list(saved_paths) != self._path_strs:
            raise ValueError(
                "data-stream state was saved for a different patient list "
                f"({len(saved_paths)} patients vs {len(self.paths)} now); the stream cannot be replayed"
            )
        with self._rng_lock:
            self.rng.bit_generator.state = state["rng"]
            self._order = list(state["order"])
            self._epoch_done = bool(state["epoch_done"])
            if self.augmenter is not None and "augmenter_rng" in state:
                self.augmenter.rng.bit_generator.state = state["augmenter_rng"]

    def _next_indices(self) -> List[int]:
        out = []
        with self._rng_lock:
            while len(out) < self.batch_size:
                if not self._order:
                    if self._epoch_done and not self.infinite:
                        if out:
                            return out
                        raise StopIteration
                    self._order = list(range(len(self.paths)))
                    self._epoch_done = True
                    if self.shuffle:
                        self.rng.shuffle(self._order)
                    else:
                        self._order.reverse()  # pop() serves from the end
                out.append(self._order.pop())
        return out

    def _sample_3d(self, data_and_seg: np.ndarray, meta: Dict) -> np.ndarray:
        target = np.broadcast_to(np.asarray(self.patch_shape), (3,))
        padded_shape = np.maximum(data_and_seg.shape[:3], target)
        pad_off = (padded_shape - np.asarray(data_and_seg.shape[:3])) // 2
        with self._rng_lock:
            guided = (
                self.p_centerline_3d > 0.0
                and len(meta.get("centerlines_world", ())) > 0
                and self.rng.random() < self.p_centerline_3d
            )
            if guided:
                idx = int(self.rng.integers(0, len(meta["centerlines_world"])))
            else:
                start = np.array([
                    int(self.rng.integers(0, padded_shape[i] - target[i] + 1)) - pad_off[i] for i in range(3)
                ])
        if guided:
            ctls = np.asarray(meta["centerlines_world"])
            point = geom.world_to_image_coords(ctls[idx, :3], meta["offset"], meta["spacing"])
            point = np.clip(point, 0, np.asarray(data_and_seg.shape[:3]) - 1)
            bbox = geom.get_patch_bounds(target, padded_shape, point + pad_off)
            start = bbox[:, 0] - pad_off
        return crop_pad_int16(data_and_seg, start, target)

    def _sample_2d(self, data_and_seg: np.ndarray, meta: Dict) -> np.ndarray:
        """A (pw, ph, 2) slice patch: 50% through a random centerline point,
        cropped around it; 50% a random z slice, randomly cropped."""
        W, H, D = data_and_seg.shape[:3]
        pw, ph = self.patch_shape
        with self._rng_lock:
            along_centerline = self.rng.random() < 0.5 and len(meta.get("centerlines_world", ())) > 0
            idx = int(self.rng.integers(0, len(meta["centerlines_world"]))) if along_centerline else 0
        if along_centerline:
            x, y, z = geom.world_to_image_coords(np.asarray(meta["centerlines_world"])[idx, :3], meta["offset"],
                                                  meta["spacing"])
            z = int(np.clip(z, 0, D - 1))
            # a scan smaller than the patch is padded first and the point
            # shifts with the pad, so the vessel stays inside
            off = [max(pw - W, 0) // 2, max(ph - H, 0) // 2]
            sl = _pad_to(np.asarray(data_and_seg[:, :, z]), (pw, ph))
            bbox = geom.get_patch_bounds((pw, ph), sl.shape[:2], np.array([x + off[0], y + off[1]]))
            return sl[bbox[0, 0] : bbox[0, 1], bbox[1, 0] : bbox[1, 1]]
        with self._rng_lock:
            z = int(self.rng.integers(0, D))
        sl = _pad_to(np.asarray(data_and_seg[:, :, z]), (pw, ph))
        with self._rng_lock:
            sx = int(self.rng.integers(0, sl.shape[0] - pw + 1))
            sy = int(self.rng.integers(0, sl.shape[1] - ph + 1))
        return sl[sx : sx + pw, sy : sy + ph]

    def _load_patient_cached(self, path: str):
        with self._patients_lock:
            hit = self._patients.get(path)
        if hit is not None:
            return hit
        loaded = load_patient(path, h5_file_cache=self._h5_files)
        with self._patients_lock:
            return self._patients.setdefault(path, loaded)

    def sample_one(self, path: str) -> Tuple[np.ndarray, str]:
        data_and_seg, meta = self._load_patient_cached(path)
        patch = (self._sample_2d if self.is_2d else self._sample_3d)(data_and_seg, meta)
        if self.augmenter is not None:
            scan, seg = self.augmenter(patch[..., 0], patch[..., 1])
            patch = np.stack([scan, seg], axis=-1)
        return patch, meta["name"]

    def next_batch(self) -> Dict:
        """{"data": (B, *patch) int16, "seg": (B, *patch) int16, "name",
        "path"}."""
        indices = self._next_indices()
        shape = (len(indices), *self.patch_shape)
        data = np.empty(shape, dtype=np.int16)
        seg = np.empty(shape, dtype=np.int16)
        names, paths = [], []
        for i, idx in enumerate(indices):
            patch, name = self.sample_one(self.paths[idx])
            data[i], seg[i] = patch[..., 0], patch[..., 1]
            names.append(name)
            paths.append(self.paths[idx])
        return {"data": data, "seg": seg, "name": names, "path": paths}

    def __iter__(self):
        while True:
            try:
                yield self.next_batch()
            except StopIteration:
                return
