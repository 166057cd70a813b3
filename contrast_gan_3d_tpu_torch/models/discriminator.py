"""3D / 2D PatchGAN critic (counterpart of
``contrast_gan_3d_tpu/models/discriminator.py``), NCDHW or NCHW tensors.

k=4, s=2, p=1 zero-padded ``ConvBlock``s with LeakyReLU(0.2): an
unnormalized first block (so it carries a bias), then
``discriminator_depth`` blocks of ``min(2^(n+1), 8) * init_channels_out``
channels with ``norm`` ("batch", None for the gradient-penalty presets,
"layer" for ``gp_layernorm``), then a k=4, s=1, p=1 conv to a 1-channel logit map: patch-wise
realism scores with no global pooling. Module names ``first``,
``middle_{n}`` and ``last`` follow the flax ones. The default config has
176,873 parameters, drawn at construction as flax draws them
(``models/utils.init_like_flax``). ``dtype`` is every block's compute
dtype (``models/blocks.py``); the logits come out in it. ``remat=True``
recomputes each block's activations in the backward
(``models/blocks.remat``), as the JAX critic's ``nn.remat`` blocks are,
through the gradient penalty's double backward too. Under spatial
partitioning (``mesh.space`` > 1, 2D or 3D) x is this rank's X-slab of
the patches and the logits are its slab of the logit map, which need not
split evenly (a 4^ndim stride-1 last conv leaves X/8 - 1 rows at depth 1,
15 over 7 / 8 at depth 3 on 128^2 slices): a rank left without logit rows
computes a phantom row and keeps none (``parallel/spatial.py``); the
blocks exchange their halos (``models/blocks.py``).
"""

from typing import Optional

import torch
from torch import nn

from contrast_gan_3d_tpu_torch.models.blocks import ConvBlock, remat
from contrast_gan_3d_tpu_torch.models.utils import init_like_flax
from contrast_gan_3d_tpu_torch.parallel.mesh import LOCAL


class PatchGANDiscriminator(nn.Module):
    def __init__(
        self,
        init_channels_out: int = 8,
        discriminator_depth: int = 3,
        ndim: int = 3,
        kernel_size: int = 4,
        negative_slope: float = 0.2,
        norm: Optional[str] = "batch",
        remat: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.discriminator_depth = discriminator_depth
        self.remat = remat
        self.mesh = LOCAL
        c0 = init_channels_out
        block = dict(padding=1, activation="leaky_relu", negative_slope=negative_slope, dtype=dtype, ndim=ndim)
        self.first = ConvBlock(1, c0, kernel_size, stride=2, norm=None, **block)
        c_in = c0
        for n in range(discriminator_depth):
            c_out = min(2 ** (n + 1), 8) * c0
            self.add_module(f"middle_{n}", ConvBlock(c_in, c_out, kernel_size, stride=2, norm=norm, **block))
            c_in = c_out
        self.last = ConvBlock(c_in, 1, kernel_size, stride=1, padding=1, norm=None, activation=None, dtype=dtype,
                              ndim=ndim)
        init_like_flax(self)

    def _blocks(self):
        return [self.first, *(getattr(self, f"middle_{n}") for n in range(self.discriminator_depth)), self.last]

    def logit_rows(self, x: torch.Tensor) -> Optional[int]:
        """Under spatial partitioning, the global extent along X of the
        logits of the X-slab ``x`` (for the losses' counts); else None."""
        if self.mesh.space == 1:
            return None
        rows = x.shape[2] * self.mesh.space
        for block in self._blocks():
            rows = block.out_rows(rows)
        return rows

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # under spatial partitioning: the patches' global extent along X
        rows = x.shape[2] * self.mesh.space if self.mesh.space > 1 else None
        for block in self._blocks():
            x = remat(block, x, rows) if self.remat else block(x, rows)
            rows = block.out_rows(rows)
        return x
