"""Full-volume CCTA contrast corrector (counterpart of
``contrast_gan_3d_tpu/eval/corrector.py``).

A user hands an int16 (W, H, D) volume to ``CCTAContrastCorrector``. With a
3D ``inference_patch_size`` the Gaussian-blended sliding window
(``ops/sliding_window.py``) runs every patch through the generator on the
device; with a 2D one (the 2D family) the axial slices go through it in
batches. Either way the f32 corrected HU volume comes back.
``from_checkpoint`` builds the corrector from a training run's ``<step>.pt``
or a JAX run's ``<step>.msgpack``, ``from_reference_checkpoint`` from a
reference ``<iteration>.pt``;
``correct_file`` reads a scan file, corrects it and writes the result
(``utils/io_utils.py``). ``shard_over(devices)`` splits every volume's
patch grid over several devices (``parallel/inference.py``).
"""

import logging
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from contrast_gan_3d_tpu_torch.data.scaler import FactorZeroCenterScaler, Scaler
from contrast_gan_3d_tpu_torch.models.generator import LAYOUTS, ResnetGenerator
from contrast_gan_3d_tpu_torch.models.utils import derive_generator_arch
from contrast_gan_3d_tpu_torch.ops.sliding_window import make_volume_corrector
from contrast_gan_3d_tpu_torch.parallel.inference import make_sharded_volume_corrector, replicas
from contrast_gan_3d_tpu_torch.trainer import checkpoint as ckpt_lib
from contrast_gan_3d_tpu_torch.utils import io_utils
from contrast_gan_3d_tpu_torch.utils.device import full_f32, resolve_device
from contrast_gan_3d_tpu_torch.utils.reference_checkpoint import load_reference_checkpoint

logger = logging.getLogger(__name__)

INT16 = np.iinfo(np.int16)


def packed_eligible(generator: nn.Module, patch_size: Tuple[int, ...], overlap: float) -> bool:
    """Whether ``layout="auto"`` runs the packed sliding window: the JAX
    corrector's test (``stride_ok`` and the generator and patch checks)."""
    stride_ok = all(int(round(p * (1.0 - overlap))) >= 4 for p in patch_size)
    if not (isinstance(generator, ResnetGenerator) and stride_ok and len(patch_size) == 3):
        return False
    n = generator.n_updownsample_blocks
    return (
        generator.layout in LAYOUTS
        and generator.norm == "batch"
        and generator.ndim == 3
        and n >= 1
        # the packed reflect pad builds from (L+1)-block slabs
        and all(p % max(4, 2**n) == 0 and p >= 8 for p in patch_size)
    )


class CCTAContrastCorrector:
    """Correct the contrast of whole CCTA volumes with a trained generator.

    ``generator``: a port ``ResnetGenerator`` holding its weights (e.g.
    carried from JAX by ``utils/weights.py``); it is moved to ``device`` and
    put in eval mode. ``device`` defaults to CUDA and raises without it.
    ``dtype``: the patches' dtype on the way into the generator, as the JAX
    corrector's; bf16 serving passes ``torch.bfloat16`` here and builds the
    generator with ``dtype=torch.bfloat16``. The blend stays f32.

    A 2-element ``inference_patch_size`` selects the 2D corrector (its
    values are not used, as in JAX): the (W, H, D) volume is scaled in f32
    and its D axial slices run through the 2D generator as ``(b, 1, W, H)``
    batches of ``b = min(batch_size, ceil(D / 8) * 8)``, the tail padded
    with zero slices; each batch's attenuation is subtracted in f32 and the
    result unscaled. The slices enter the generator in f32, as the JAX 2D
    path feeds them (a bf16 generator's first block casts them), so
    ``dtype`` does not apply.

    ``layout``: "auto" (the default, as in JAX) runs the 3D sliding window
    in block space (``packed_io``, ``ResnetGenerator.forward_packed``)
    whenever the generator and the window allow it: a 3D batch-norm
    ``ResnetGenerator`` with ``n_updownsample_blocks >= 1``, every patch
    dim a multiple of ``max(4, 2**n)`` and at least 8, and every stride
    ``round(p * (1 - overlap))`` at least 4; otherwise the direct window.
    "packed" raises where that does not hold; "direct" forces the direct
    window. The packed grid snaps strides down to multiples of 4 and pads
    dims up to multiples of 4, so for such scans the two layouts are
    different functions; "auto" is the JAX package's default answer.
    Pass the generator plain: one built with ``packed_input`` or
    ``packed_output`` raises. ``batch_size`` None means the JAX choice: 24
    packed and 8 direct for 3D; for 2D 128 on the card and 8 on the CPU.

    ``z_bucket`` > 0 edge-pads a volume's z extent up to the next multiple
    of it, corrects, and crops back, as the JAX corrector does (a daemon
    then sees few distinct shapes; ``serve`` defaults it to 64). For 2D
    the padded slices are corrected on their own and cropped, so the
    result is unchanged; in 3D the padded extent changes the patch grid
    and with it the blend. 0, the default, corrects every extent as it
    is. ``dispatched_shapes`` records each distinct (W, H, z) dispatched
    after bucketing, once its correction has returned; read it under
    ``_shapes_lock`` from other threads.
    """

    def __init__(
        self,
        generator: nn.Module,
        inference_patch_size: Tuple[int, ...] = (128, 128, 128),
        overlap: float = 0.5,
        batch_size: Optional[int] = None,
        scaler: Scaler = FactorZeroCenterScaler(),
        layout: str = "auto",
        device="cuda",
        dtype: torch.dtype = torch.float32,
        z_bucket: int = 0,
    ):
        self.device = resolve_device(device)
        if len(inference_patch_size) not in (2, 3):
            raise ValueError(f"inference_patch_size must have 2 or 3 values, got {inference_patch_size}")
        if layout not in ("auto", "packed", "direct"):
            raise ValueError(f"unknown layout {layout!r}: expected auto | packed | direct")
        self.is_2d = len(inference_patch_size) == 2
        if not self.is_2d and isinstance(generator, ResnetGenerator) and (
            generator.packed_input or generator.packed_output
        ):
            raise ValueError("pass the plain full-resolution generator module: the corrector adds "
                             "packed_input/packed_output itself")
        self.packed = layout in ("auto", "packed") and not self.is_2d and packed_eligible(
            generator, inference_patch_size, overlap)
        if layout == "packed" and not self.packed:
            raise ValueError("layout='packed' unsupported for this generator/patch")
        self.generator = generator.to(self.device).eval()
        self.scaler = scaler
        self.inference_patch_size = tuple(inference_patch_size)
        self.overlap = overlap
        self.z_bucket = int(z_bucket)
        self.dtype = dtype
        self.dispatched_shapes: set = set()
        self._shapes_lock = threading.Lock()
        if batch_size is None:
            batch_size = (128 if self.device.type == "cuda" else 8) if self.is_2d else (24 if self.packed else 8)
        self.batch_size = batch_size
        if self.is_2d:
            self.correct_volume = self._correct_2d
            return
        apply = (lambda x: self.generator.forward_packed(x, packed_input=True, packed_output=True)) \
            if self.packed else self.generator
        self.correct_volume = make_volume_corrector(
            apply,
            patch_size=self.inference_patch_size,
            overlap=overlap,
            batch_size=batch_size,
            scaler=scaler,
            device=self.device,
            dtype=dtype,
            packed_io=self.packed,
        )

    @classmethod
    def from_checkpoint(
        cls,
        checkpoint_dir,
        generator: Optional[nn.Module] = None,
        iteration: Optional[int] = None,
        **kwargs,
    ) -> "CCTAContrastCorrector":
        """Build from a training checkpoint: ``<step>.pt`` (the latest in
        ``checkpoint_dir``, or ``iteration``'s), or that file itself; a JAX
        run's ``<step>.msgpack`` where the directory has no ``<step>.pt``
        (read without JAX, ``trainer/checkpoint.load_generator``).

        With no ``generator`` the architecture is read from the weights
        (``derive_generator_arch``) and updated with the meta sidecar's
        ``tconv_placement`` and ``norm``; the generator is built at f32, as
        the JAX package builds it, and loads the weights strictly. The
        corrector's ``dtype`` then only casts the patches: with
        ``dtype=torch.bfloat16`` the scaled patches are rounded to bf16 and
        the f32 generator casts them back, computing in f32, as flax's f32
        modules do with bf16 inputs. ``kwargs`` go to the constructor."""
        payload = ckpt_lib.load_generator(checkpoint_dir, iteration=iteration)
        if generator is None:
            gen_kwargs = derive_generator_arch(payload["state_dict"])
            gen_kwargs.update(payload["meta"].get("generator", {}))
            generator = ResnetGenerator(**gen_kwargs)
            logger.info("Auto-derived generator architecture: %s", gen_kwargs)
        generator.load_state_dict(payload["state_dict"], strict=True)
        logger.info("Loaded generator from '%s' @ iteration %s", checkpoint_dir, payload["step"])
        return cls(generator, **kwargs)

    @classmethod
    def from_reference_checkpoint(
        cls,
        pt_path,
        n_resnet_blocks: Optional[int] = None,
        n_updownsample_blocks: Optional[int] = None,
        init_channels_out: Optional[int] = None,
        ndim: Optional[int] = None,
        dtype: torch.dtype = torch.float32,
        **kwargs,
    ) -> "CCTAContrastCorrector":
        """Build from a reference ``<iteration>.pt`` (the torch checkpoint of
        reference ``trainer/Trainer.py:321-327``; ``utils/
        reference_checkpoint.py``), so users of the reference correct volumes
        with the checkpoints they have. The architecture comes from the
        file's state dict; explicit values that disagree raise. The
        generator is built with ``tconv_placement="torch"``, the reference's
        transpose-conv window, and with ``dtype``, which also goes to the
        corrector, as in JAX. A 2D file wants a 2-element
        ``inference_patch_size``. ``kwargs`` go to the constructor."""
        payload = load_reference_checkpoint(pt_path, n_resnet_blocks, n_updownsample_blocks)
        arch = payload["generator_arch"]
        for name, given in (("init_channels_out", init_channels_out), ("ndim", ndim)):
            if given is not None and given != arch[name]:
                raise ValueError(f"{name}={given} does not match the checkpoint (found {arch[name]})")
        generator = ResnetGenerator(**arch, tconv_placement="torch", dtype=dtype)
        generator.load_state_dict(payload["generator"], strict=True)
        logger.info("Ported reference checkpoint '%s' @ iteration %d", pt_path, payload["iteration"])
        return cls(generator, dtype=dtype, **kwargs)

    def shard_over(self, devices) -> "CCTAContrastCorrector":
        """Split every volume's patch grid over ``devices`` (a list; a device
        may repeat), keeping the layout: a packed corrector runs the packed
        sharded window (``parallel/inference.make_sharded_volume_corrector``,
        the JAX ``shard_over``). Each distinct device gets a replica of the
        generator; the volume and the result live on ``devices[0]``, which
        becomes ``self.device``. Returns ``self``."""
        if self.is_2d:
            raise ValueError("shard_over applies to the 3D sliding window only")
        devices = [resolve_device(d) for d in devices]
        reps = replicas(self.generator, devices)
        if self.packed:
            apply = lambda x, d: reps[d].forward_packed(x, packed_input=True, packed_output=True)
        else:
            apply = lambda x, d: reps[d](x)
        self.correct_volume = make_sharded_volume_corrector(
            apply, devices, patch_size=self.inference_patch_size, overlap=self.overlap, batch_size=self.batch_size,
            scaler=self.scaler, dtype=self.dtype, packed_io=self.packed)
        self.device = devices[0]
        self.devices = devices
        return self

    def _correct_2d(self, volume) -> torch.Tensor:
        """Axial-slice batched 2D correction: (W, H, D) -> (W, H, D) f32 HU."""
        volume = torch.as_tensor(volume)
        W, H, D = volume.shape
        slices = self.scaler(volume.to(self.device, torch.float32)).permute(2, 0, 1).unsqueeze(1)
        bs = min(self.batch_size, -(-D // 8) * 8)
        pad = (-D) % bs
        if pad:
            slices = torch.cat([slices, slices.new_zeros((pad, 1, W, H))])
        out = torch.empty_like(slices)
        for b0 in range(0, len(slices), bs):
            batch = slices[b0 : b0 + bs]
            out[b0 : b0 + bs] = batch - self.generator(batch).float()
        return self.scaler.unscale(out[:D, 0].permute(1, 2, 0).contiguous())

    @torch.inference_mode()
    def __call__(self, volume) -> torch.Tensor:
        """Correct one (W, H, D) HU volume (int16/float); f32 HU out, on
        ``self.device``. f32 convolutions run in full f32, whatever the
        process's TF32 switches (``utils/device.full_f32``)."""
        with full_f32():
            return self.correct(volume)

    def correct(self, volume) -> torch.Tensor:
        """``__call__`` without its inference mode and its f32 scope
        (``eval/export.py`` traces this under ``torch.no_grad``; the
        artifact sets the scope when it runs). ``pad`` is the one source
        of both the padding and the recorded shape."""
        volume = torch.as_tensor(volume)
        d = volume.shape[2]
        pad = self.z_bucket - d % self.z_bucket if self.z_bucket > 0 and d % self.z_bucket else 0
        if pad:
            volume = volume.to(self.device)
            edge = volume[:, :, -1:].expand(-1, -1, pad)
            corrected = self.correct_volume(torch.cat([volume, edge], dim=2))[:, :, :d]
        else:
            corrected = self.correct_volume(volume)
        with self._shapes_lock:
            self.dispatched_shapes.add((volume.shape[0], volume.shape[1], d + pad))
        return corrected

    def correct_file(self, scan_path, out_path=None, meta=None) -> np.ndarray:
        """Load a scan file (``io_utils.load_scan``), correct it, and write
        it to ``out_path`` if given; returns the f32 corrected volume."""
        volume, file_meta = io_utils.load_scan(scan_path)
        corrected = self(volume).cpu().numpy()
        if out_path is not None:
            self.save(corrected, out_path, meta or file_meta)
        return corrected

    @staticmethod
    def save(corrected, out_path, meta: dict):
        """Write a corrected volume: rounded half to even and clipped to
        int16 (an int16 volume is written as it is), then ``save_scan`` with
        the meta's offset, spacing and direction."""
        out_path = Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        if isinstance(corrected, torch.Tensor):
            corrected = corrected.cpu().numpy()
        vol = corrected if corrected.dtype == np.int16 else \
            np.clip(np.round(corrected), INT16.min, INT16.max).astype(np.int16)
        io_utils.save_scan(vol, meta.get("offset"), meta.get("spacing"), out_path, direction=meta.get("direction"))
        logger.info("Saved corrected scan to '%s'", out_path)
