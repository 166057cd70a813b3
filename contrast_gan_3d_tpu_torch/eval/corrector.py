"""Full-volume CCTA contrast corrector (counterpart of
``contrast_gan_3d_tpu/eval/corrector.py``; 3D, direct layout).

A user hands an int16 (W, H, D) volume to ``CCTAContrastCorrector``; the
Gaussian-blended sliding window (``ops/sliding_window.py``) runs every patch
through the generator on the device and returns the f32 corrected HU volume.
"""

from typing import Tuple

import torch
from torch import nn

from contrast_gan_3d_tpu_torch.data.scaler import FactorZeroCenterScaler, Scaler
from contrast_gan_3d_tpu_torch.ops.sliding_window import make_volume_corrector
from contrast_gan_3d_tpu_torch.utils.device import resolve_device


class CCTAContrastCorrector:
    """Correct the contrast of whole CCTA volumes with a trained generator.

    ``generator``: a port ``ResnetGenerator`` holding its weights (e.g.
    carried from JAX by ``utils/weights.py``); it is moved to ``device`` and
    put in eval mode. ``device`` defaults to CUDA and raises without it.
    ``dtype``: the patches' dtype on the way into the generator, as the JAX
    corrector's; bf16 serving passes ``torch.bfloat16`` here and builds the
    generator with ``dtype=torch.bfloat16``. The blend stays f32.
    """

    def __init__(
        self,
        generator: nn.Module,
        inference_patch_size: Tuple[int, ...] = (128, 128, 128),
        overlap: float = 0.5,
        batch_size: int = 8,
        scaler: Scaler = FactorZeroCenterScaler(),
        layout: str = "direct",
        device="cuda",
        dtype: torch.dtype = torch.float32,
    ):
        self.device = resolve_device(device)
        if len(inference_patch_size) != 3:
            raise NotImplementedError("the 2D corrector is not ported yet; see ROADMAP.md")
        if layout != "direct":
            raise NotImplementedError(
                f"layout={layout!r} is not ported yet (only 'direct'); see ROADMAP.md"
            )
        self.generator = generator.to(self.device).eval()
        self.scaler = scaler
        self.inference_patch_size = tuple(inference_patch_size)
        self.overlap = overlap
        self.batch_size = batch_size
        self.correct_volume = make_volume_corrector(
            self.generator,
            patch_size=self.inference_patch_size,
            overlap=overlap,
            batch_size=batch_size,
            scaler=scaler,
            device=self.device,
            dtype=dtype,
        )

    @torch.inference_mode()
    def __call__(self, volume) -> torch.Tensor:
        """Correct one (W, H, D) HU volume (int16/float); f32 HU out, on
        ``self.device``."""
        return self.correct_volume(volume)
