"""ResNet-style attenuation generator (counterpart of
``contrast_gan_3d_tpu/models/generator.py``, direct layout, 2D or 3D).

7^ndim reflect-padded stem -> ``n_updownsample_blocks`` stride-2
downsamples (channels doubling) -> ``n_resnet_blocks`` residual blocks ->
mirrored transpose-conv upsamples -> 7^ndim reflect-padded projection to 1
channel -> tanh. Input and output are ``(B, 1, X, Y, Z)`` (3D) or ``(B, 1,
X, Y)`` (``ndim=2``, the 2D family); the output is a bounded attenuation
map in (-1, 1) that the caller subtracts.

In 3D with ``s2d_factor=4`` (the default) the stem and projection run
through space-to-depth and the block-conv kernel (B3 -> B1). In 2D
``s2d_factor`` is ignored, as in the JAX block: every conv is cuDNN's.
The default config has 1,035,297 parameters.

``dtype`` is the compute dtype of every block (``models/blocks.py``): the
first block casts the input to it and the attenuation comes out in it;
parameters and BatchNorm statistics stay f32.
"""

from typing import Optional

import torch
from torch import nn

from contrast_gan_3d_tpu_torch.models.blocks import ROADMAP_NOTE, ConvBlock, ResNetBlock


class ResnetGenerator(nn.Module):
    def __init__(
        self,
        n_resnet_blocks: int = 4,
        n_updownsample_blocks: int = 2,
        init_channels_out: int = 16,
        ndim: int = 3,
        resnet_dropout_prob: float = 0.0,
        resnet_padding_mode: str = "zeros",
        norm: str = "batch",
        s2d_factor: Optional[int] = 4,
        tconv_placement: str = "same",
        layout: str = "direct",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if n_resnet_blocks <= 0:
            raise ValueError("n_resnet_blocks must be positive")
        if layout == "packed":
            raise NotImplementedError(f"layout='packed' is {ROADMAP_NOTE}")
        if layout != "direct":
            raise ValueError(f"unknown layout {layout!r}")
        self.n_resnet_blocks = n_resnet_blocks
        self.n_updownsample_blocks = n_updownsample_blocks
        # what the weights cannot encode: the trainer's checkpoint meta
        # sidecar records these, and ``from_checkpoint`` rebuilds from them
        self.tconv_placement = tconv_placement
        self.norm = norm
        c0 = init_channels_out

        self.first = ConvBlock(
            1, c0, 7, padding=3, padding_mode="reflect", norm=norm,
            activation="relu", s2d=s2d_factor, dtype=dtype, ndim=ndim,
        )
        for i in range(n_updownsample_blocks):
            self.add_module(f"down_{i}", ConvBlock(
                c0 * 2**i, c0 * 2 ** (i + 1), 3, stride=2, padding=1, norm=norm,
                activation="relu", dtype=dtype, ndim=ndim,
            ))
        bottleneck = c0 * 2**n_updownsample_blocks
        for i in range(n_resnet_blocks):
            self.add_module(f"resnet_{i}", ResNetBlock(
                bottleneck, dropout_prob=resnet_dropout_prob,
                padding_mode=resnet_padding_mode, norm=norm, dtype=dtype, ndim=ndim,
            ))
        for i in range(n_updownsample_blocks, 0, -1):
            self.add_module(f"up_{i - 1}", ConvBlock(
                c0 * 2**i, c0 * 2 ** (i - 1), 3, stride=2, transpose=True,
                norm=norm, activation="relu", tconv_placement=tconv_placement, dtype=dtype, ndim=ndim,
            ))
        self.last_conv = ConvBlock(
            c0, 1, 7, padding=3, padding_mode="reflect", norm=None,
            activation="tanh", s2d=s2d_factor, dtype=dtype, ndim=ndim,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.first(x)
        n = self.n_updownsample_blocks
        for i in range(n):
            x = getattr(self, f"down_{i}")(x)
        for i in range(self.n_resnet_blocks):
            x = getattr(self, f"resnet_{i}")(x)
        for i in range(n, 0, -1):
            x = getattr(self, f"up_{i - 1}")(x)
        return self.last_conv(x)
