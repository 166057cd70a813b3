"""Prefetching loaders (counterpart of ``contrast_gan_3d_tpu/data/
pipeline.py``): worker threads draw int16 batches from a sampler into a
bounded queue, and with ``to_device`` ship them to the card ahead of the
step.

The copy to a CUDA device never goes through pageable memory: the worker
copies the batch into pinned host tensors, issues a ``non_blocking`` copy
on the loader's side stream and records an event; the consumer's stream
waits on that event in ``__next__`` and the device tensors are marked with
``record_stream`` for it, so the caching allocator does not reuse them
early. ``device="cpu"`` hands out CPU tensors; ``to_device=False`` the
numpy arrays themselves.

Lifecycle, error surfacing and replay are the JAX package's: a worker's
exception is raised in the consumer (no hang); finite samplers end the
iteration after one full pass; with one worker thread ``get_state`` is the
sampler state after the last batch SERVED, so a restore re-produces the
batches that sat in the queue.
"""

import dataclasses
import logging
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from contrast_gan_3d_tpu_torch.data.labeling import divide_scans_in_fold
from contrast_gan_3d_tpu_torch.data.sampler import CCTAPatchSampler
from contrast_gan_3d_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

_ARRAYS = ("data", "seg")


class PrefetchLoader:
    """Wrap a sampler with background prefetch and an early device copy."""

    def __init__(self, sampler: CCTAPatchSampler, num_threads: int = 2, prefetch: int = 3,
                 to_device: bool = True, device="cuda"):
        self.sampler = sampler
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.to_device = to_device
        self.device = resolve_device(device) if to_device else None
        self._stream = None  # the side stream of a CUDA loader, made in start()
        self._queue: Optional[queue.Queue] = None
        self._threads = []
        self._stop = threading.Event()
        self._sentinel = object()
        self._done_box = {"n": 0}
        self._err_box = {"e": None}
        self._done_lock = threading.Lock()
        self._zombies = []
        self._last_state: Optional[Dict] = None

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        if self._threads:
            return
        self._await_zombies()
        if self._last_state is None:
            self._last_state = self.sampler.get_state()
        elif self.num_threads == 1:
            # a stop() dropped queued batches the sampler had drawn past:
            # rewind to the last batch served
            self.sampler.set_state(self._last_state)
        if self.device is not None and self.device.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        # fresh per-generation objects: a worker that outlived stop() holds
        # the old ones and can never produce into this generation
        self._stop = threading.Event()
        self._done_box = {"n": 0}
        self._err_box = {"e": None}
        self._queue = queue.Queue(maxsize=self.prefetch + self.num_threads)
        for i in range(self.num_threads):
            t = threading.Thread(target=self._worker, args=(self._stop, self._queue, self._done_box, self._err_box),
                                 name=f"prefetch-{i}", daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self):
        self._stop.set()
        if self._queue is not None:
            try:  # drain so workers blocked on put() see the stop flag
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
        for t in self._threads:
            t.join(timeout=5)
            if t.is_alive():
                logger.warning("prefetch worker %s did not stop in 5 s", t.name)
                self._zombies.append(t)
        self._threads = []

    def _fail(self, done_box, err_box, q, e=None):
        with self._done_lock:
            done_box["n"] += 1
            if e is not None and err_box["e"] is None:
                err_box["e"] = e
        q.put(self._sentinel)  # space reserved in maxsize

    def _transfer(self, batch: Dict) -> Dict:
        batch = dict(batch)
        if self.device.type != "cuda":
            for k in _ARRAYS:
                batch[k] = torch.from_numpy(np.ascontiguousarray(batch[k]))
            return batch
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            for k in _ARRAYS:
                pinned = torch.from_numpy(np.ascontiguousarray(batch[k])).pin_memory()
                batch[k] = pinned.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        batch["_ready"] = ready
        return batch

    def _worker(self, stop: threading.Event, q: queue.Queue, done_box: Dict, err_box: Dict):
        track = self.num_threads == 1  # the draw order is defined only then
        while not stop.is_set():
            try:
                batch = self.sampler.next_batch()
                state_after = self.sampler.get_state() if track else None
            except StopIteration:
                self._fail(done_box, err_box, q)
                return
            except Exception as e:  # surfaced in the consumer
                self._fail(done_box, err_box, q, e)
                return
            try:
                if self.to_device:
                    batch = self._transfer(batch)
            except Exception as e:  # a device copy can fail too (OOM)
                self._fail(done_box, err_box, q, e)
                return
            while not stop.is_set():
                try:
                    q.put((state_after, batch), timeout=0.5)
                    break
                except queue.Full:
                    continue

    # -- resumable stream ---------------------------------------------------
    def get_state(self) -> Dict:
        """The stream at the consumer's position (one worker thread); with
        several the raw sampler state (approximate resume)."""
        if self.num_threads == 1 and self._last_state is not None:
            return self._last_state
        return self.sampler.get_state()

    def _await_zombies(self):
        for t in self._zombies:
            t.join(timeout=10)
        if any(t.is_alive() for t in self._zombies):
            raise RuntimeError("a prefetch worker from a previous generation still holds this loader's sampler; "
                               "proceeding would corrupt the data stream")
        self._zombies = []

    def set_state(self, state: Dict):
        if self._threads:
            raise RuntimeError("stop() the loader before set_state()")
        self._await_zombies()
        self.sampler.set_state(state)
        self._last_state = state

    def _maybe_raise_worker_error(self):
        with self._done_lock:
            e = self._err_box["e"]
        if e is not None:
            raise RuntimeError("prefetch worker failed") from e

    # -- iteration ----------------------------------------------------------
    def _serve(self, item) -> Dict:
        state_after, batch = item
        if state_after is not None:
            self._last_state = state_after
        ready = batch.pop("_ready", None) if isinstance(batch, dict) else None
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for k in _ARRAYS:
                batch[k].record_stream(stream)
        return batch

    def __next__(self) -> Dict:
        if not self._threads:
            self.start()
        while True:
            self._maybe_raise_worker_error()
            try:
                item = self._queue.get(timeout=1.0)
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration
                with self._done_lock:
                    all_done = self._done_box["n"] >= len(self._threads)
                if not all_done:
                    continue
                try:
                    # a worker may have posted its final batch between the
                    # timeout and the done check
                    item = self._queue.get_nowait()
                except queue.Empty:
                    self._maybe_raise_worker_error()
                    raise StopIteration
            if item is self._sentinel:
                self._maybe_raise_worker_error()
                with self._done_lock:
                    all_done = self._done_box["n"] >= len(self._threads)
                if all_done and self._queue.empty():
                    raise StopIteration
                continue
            return self._serve(item)

    def __iter__(self) -> Iterator[Dict]:
        return self


def create_loaders(fold, patch_shape, batch_sizes: Dict[int, int], rng: np.random.Generator,
                   num_threads: int = 2, prefetch: int = 3, to_device: bool = True, device="cuda",
                   augmenter=None, p_centerline_3d: float = 0.0) -> Dict[int, PrefetchLoader]:
    """One prefetching loader per ScanType label in the fold; every sampler
    (and its copy of the host ``augmenter``) gets its own child generator
    of ``rng``, spawned as the JAX package spawns them."""
    loaders = {}
    for label, paths in divide_scans_in_fold(fold).items():
        child_rng, aug_rng = rng.spawn(2)
        loader_augmenter = dataclasses.replace(augmenter, rng=aug_rng) if augmenter is not None else None
        sampler = CCTAPatchSampler(paths, patch_shape, batch_sizes[label], rng=child_rng,
                                   augmenter=loader_augmenter, p_centerline_3d=p_centerline_3d)
        loaders[label] = PrefetchLoader(sampler, num_threads=num_threads, prefetch=prefetch,
                                        to_device=to_device, device=device)
    return loaders
