"""Patient-level correction (counterpart of
``contrast_gan_3d_tpu/eval/utils.py``): correct one patient, a raw
.mhd/.nii/.h5 scan or a preprocessed .npy/.h5 patient, and write the result; or
stream a cohort through one corrector with the host I/O overlapped."""

import logging
import queue
import threading
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from contrast_gan_3d_tpu_torch.data import hdf5
from contrast_gan_3d_tpu_torch.data.preprocess import load_patient
from contrast_gan_3d_tpu_torch.eval.corrector import CCTAContrastCorrector
from contrast_gan_3d_tpu_torch.utils import io_utils

logger = logging.getLogger(__name__)

_SCAN_SUFFIXES = (".mhd", ".mha", ".nii", ".nii.gz")
INT16 = np.iinfo(np.int16)


def load_patient_or_scan(patient_path):
    """A raw image file or a preprocessed patient -> ((W, H, D) int16, meta).
    An ``.h5`` path is an HDF5 patient or corpus member (``scan_and_mask``,
    ``data/hdf5.py``) or a raw HDF5 scan (``image``): the patient schema is
    probed first. A member address names a patient only, so a missing
    member raises the ``KeyError`` that lists the members there are."""
    p = str(patient_path)
    if p.lower().endswith(_SCAN_SUFFIXES):
        return io_utils.load_scan(p)
    if hdf5.is_hdf5_path(p):
        try:
            scan_and_mask, meta = hdf5.open_patient_h5(p)
        except KeyError:
            if hdf5.split_member(p)[1] is not None:
                raise
            return io_utils.load_scan(p)
        return np.asarray(scan_and_mask[..., 0]), meta
    scan_and_mask, meta = load_patient(p)
    return np.array(scan_and_mask[..., 0]), meta  # read out of the memmap


def device_int16(corrected: torch.Tensor) -> torch.Tensor:
    """The corrected HU volume rounded half to even and clipped to int16 on
    its device: the fetch then moves half the bytes (210 MB instead of 420 MB
    for 512x512x400). ``CCTAContrastCorrector.save`` writes the same values
    from an f32 volume."""
    return torch.round(corrected).clamp_(INT16.min, INT16.max).to(torch.int16)


def _savepath(savedir, patient_path, suffix: str) -> Path:
    return io_utils.with_image_suffix(Path(savedir) / io_utils.stem(patient_path), suffix)


def correct_patient(corrector: CCTAContrastCorrector, savedir, patient_path, suffix: str = ".mhd") -> Path:
    """Correct one patient and write ``<savedir>/<name><suffix>`` (.mhd,
    .nii, .nii.gz or .h5)."""
    scan, meta = load_patient_or_scan(patient_path)
    savepath = _savepath(savedir, patient_path, suffix)
    corrector.save(device_int16(corrector(scan)), savepath, meta)
    return savepath


def correct_patients(
    corrector: CCTAContrastCorrector,
    savedir,
    patient_paths: Sequence,
    overlap_io: bool = True,
    suffix: str = ".mhd",
    stop_requested=None,
    load_fn=None,
    save_fn=None,
) -> list:
    """Correct a cohort with one corrector; returns the written paths in
    order.

    With ``overlap_io`` (the default) a loader thread reads and decodes the
    next scan and, on the card, starts its H2D copy from pinned memory on a
    side stream; the calling thread corrects; a writer thread fetches the
    previous int16 result and encodes it. Each volume runs the same ops in
    the same order as in the sequential path, so the files are
    bit-identical where the kernels are deterministic (on the card:
    ``torch.backends.cudnn.deterministic``, which ``correct_scans`` sets).
    An error in either thread is raised here, after both threads have
    stopped.

    ``stop_requested``: a callable polled between volumes; when it returns
    true the volumes already corrected are still written and the rest are
    skipped. ``load_fn(path) -> (scan, meta)`` and ``save_fn(corrected_int16,
    savepath, meta)`` replace the disk endpoints."""
    paths = list(patient_paths)
    load = load_fn if load_fn is not None else load_patient_or_scan
    save_fn = save_fn if save_fn is not None else corrector.save  # fetches the int16 volume

    def stopped() -> bool:
        if stop_requested is not None and stop_requested():
            logger.warning("Graceful stop: finishing the volumes in flight, skipping the rest")
            return True
        return False

    if not overlap_io or len(paths) <= 1:
        out = []
        for p in paths:
            if stopped():
                break
            scan, meta = load(p)
            savepath = _savepath(savedir, p, suffix)
            save_fn(device_int16(corrector(scan)), savepath, meta)
            out.append(savepath)
        return out

    on_card = corrector.device.type == "cuda"
    copy_stream = torch.cuda.Stream(device=corrector.device) if on_card else None
    load_q: queue.Queue = queue.Queue(maxsize=2)
    write_q: queue.Queue = queue.Queue(maxsize=2)
    errors: list = []
    stop = threading.Event()

    def put(q, item) -> bool:
        """A bounded put that gives up on shutdown."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def loader():
        try:
            for p in paths:
                if stop.is_set():
                    return
                scan, meta = load(p)
                ready = None
                if on_card and not isinstance(scan, torch.Tensor):
                    # a page-locked copy, for an asynchronous H2D copy
                    host = torch.from_numpy(np.require(scan, requirements=("C", "W"))).pin_memory()
                    with torch.cuda.stream(copy_stream):
                        scan = host.to(corrector.device, non_blocking=True)
                        ready = torch.cuda.Event()
                        ready.record(copy_stream)
                if not put(load_q, (scan, ready, meta, p)):
                    return
        except Exception as e:  # raised in the calling thread
            errors.append(e)
        finally:
            put(load_q, None)

    def writer():
        while True:
            item = write_q.get()
            if item is None:
                return
            corrected, savepath, meta = item
            try:
                save_fn(corrected, savepath, meta)
            except Exception as e:
                errors.append(e)
                stop.set()
                return

    lt = threading.Thread(target=loader, name="correct-loader", daemon=True)
    wt = threading.Thread(target=writer, name="correct-writer", daemon=True)
    lt.start()
    wt.start()
    out = []
    try:
        while not errors:
            if stopped():
                break
            try:
                item = load_q.get(timeout=0.2)
            except queue.Empty:
                continue
            if item is None:
                break
            scan, ready, meta, p = item
            if ready is not None:
                # the copy ran on the side stream: order it before the
                # correction, and tell the allocator the tensor is used here
                torch.cuda.current_stream(corrector.device).wait_event(ready)
                scan.record_stream(torch.cuda.current_stream(corrector.device))
            logger.info("Correcting %r", str(p))
            savepath = _savepath(savedir, p, suffix)
            if not put(write_q, (device_int16(corrector(scan)), savepath, meta)):
                break
            out.append(savepath)
    finally:
        # let the writer drain its queue, then stop both threads
        put(write_q, None)
        wt.join()
        stop.set()
        lt.join()
    if errors:
        raise errors[0]
    return out


# the reference's name for the cohort function
parallel_correct_patients = correct_patients
