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
The default config has 1,035,297 parameters. Its initial weights are
drawn as flax draws the JAX generator's (``models/utils.init_like_flax``:
``lecun_normal`` kernels, zero biases), in both layouts.

``layout="packed"`` (3D, ``norm="batch"``, ``n_updownsample_blocks >= 1``)
runs the same modules and ``state_dict`` in block space (``ops/packed.py``):
the stem, the downsamples, ``up_0`` and the projection keep their
activations space-to-depth packed across stage boundaries, the reflect
pads are built in packed space, every upsample is a forward stride-1 conv
with packed output (the inner ones unpacked for the next), and the ResNet
blocks run the direct modules on a channels-last view. B1/B3 do not run
there: the stage convs go through ``ops/s2d_conv.conv3d_cl``, the 3xTF32
tensor-core kernel (``ops/packed_conv.py``) for f32 without a gradient
(correction), cuDNN's otherwise (training, bf16), and the ResNet blocks'
convs are cuDNN's. Spatial dims must divide
``max(4, 2**n_updownsample_blocks)``. ``packed_input``: the
input is already f=2 packed, ``(B, X/2, Y/2, Z/2, 8)`` channels-last;
``packed_output``: the f=4 packed attenuation ``(B, X/4, Y/4, Z/4, 64)``
comes out. ``forward_packed`` runs the packed layout on a generator of
either layout (the corrector's packed sliding window); it and
``packed_prefix`` (the layout up to one stage: ``b96_probe``'s stage
gradients) share one stage loop, ``packed_stages``.

``dtype`` is the compute dtype of every block (``models/blocks.py``): the
first block casts the input to it and the attenuation comes out in it;
parameters and BatchNorm statistics stay f32. The packed layout casts the
input before its space-to-depth, the transformed kernels and biases to
the activations' dtype, and normalises in ``dtype``, as ``_packed_call``
does.

``remat=True`` recomputes each block's activations in the backward
(``models/blocks.remat``), where the JAX generator wraps its blocks in
``nn.remat``: in the direct layout every ``ConvBlock`` and
``ResNetBlock``; in the packed layout every packed stage and ResNet
block. It trades time for memory; the results are the same.

Under spatial partitioning (``mesh.space`` S > 1, set by
``models/norm.set_mesh``) x is this rank's X-slab of the patches,
``(B, 1, X/S, Y, Z)`` or, in 2D, ``(B, 1, X/S, Y)``, and so is the
output. In the direct layout every
block exchanges its conv halos with the other slabs (``models/
blocks.py``), and the stem and the projection run B3 -> B1 on each
extended slab, whatever its rows, where Y and Z divide 4. In the packed
layout each slab must hold whole blocks at every stage
(:func:`packed_slab_note`): the stages exchange halos in block rows
(``ops/packed.packed_conv3d_padded`` / ``packed_tconv3d`` under the
mesh), reflect only at the global ends, and normalise over the global
count; the ResNet blocks take their direct slabs. The 2D family has the
direct layout only; its convs are cuDNN's on every slab.
"""

from typing import Optional

import torch
from torch import nn

from contrast_gan_3d_tpu_torch.models.blocks import ConvBlock, ResNetBlock, remat
from contrast_gan_3d_tpu_torch.models.utils import init_like_flax
from contrast_gan_3d_tpu_torch.ops.packed import packed_conv3d_padded, packed_tconv3d
from contrast_gan_3d_tpu_torch.ops.s2d_conv import depth_to_space, space_to_depth
from contrast_gan_3d_tpu_torch.parallel.mesh import LOCAL
from contrast_gan_3d_tpu_torch.parallel.spatial import bounds
from contrast_gan_3d_tpu_torch.utils.spans import span

LAYOUTS = ("direct", "packed")


def _packed_stage(block: ConvBlock, xp: torch.Tensor, f_view: int, conv_fn, rows: Optional[int] = None
                  ) -> torch.Tensor:
    """``block``'s conv run by the block-space ``conv_fn(xp, kernel,
    bias)`` on its f32 parameters, then its BatchNorm over an (f_view, C)
    channel view of the packed tensor (the direct layout's statistics and
    count), then its activation. ``rows``: under spatial partitioning, the
    output's global extent in block rows (dim 1), from which the norm
    counts (its view keeps the block rows as its slab dim)."""
    y = conv_fn(xp, block.flax_kernel(), block.conv.bias)
    if block.norm is not None:
        c = y.shape[-1] // f_view
        if rows is None:
            y = block.norm(y.reshape(-1, c)).reshape(y.shape)
        else:  # (B, c, X-blocks, rest): channels at dim 1, the slab at dim 2
            v = y.reshape(y.shape[0], y.shape[1], -1, c).permute(0, 3, 1, 2)
            y = block.norm(v, rows).permute(0, 2, 3, 1).reshape(y.shape)
    return block.activate(y)


def packed_slab_note(rows: int, space: int, n_updownsample_blocks: int) -> Optional[str]:
    """Why the packed layout cannot split a first patch dim of ``rows``
    over ``space`` ranks (None: it can): every slab must hold whole blocks
    at every stage, a multiple of ``max(4, 2**n)`` voxel rows, and at
    least 8 of them for the reflect pad's (L+1)-block boundary slab."""
    if space == 1:
        return None
    block = max(4, 2**n_updownsample_blocks)
    slabs = sorted({hi - lo for lo, hi in (bounds(rows, space, q) for q in range(space))})
    if all(r % block == 0 and r >= 8 for r in slabs):
        return None
    return (f"the packed layout splits a first patch dim of {rows} over {space} spatial ranks in slabs of {slabs} "
            f"rows; each must be a multiple of {block} and at least 8")


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
        packed_input: bool = False,
        packed_output: bool = False,
        remat: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if n_resnet_blocks <= 0:
            raise ValueError("n_resnet_blocks must be positive")
        if layout not in LAYOUTS:
            raise ValueError(f"unknown layout {layout!r}")
        if (packed_input or packed_output) and layout != "packed":
            raise ValueError("packed_input / packed_output need layout='packed'")
        self.n_resnet_blocks = n_resnet_blocks
        self.n_updownsample_blocks = n_updownsample_blocks
        self.init_channels_out = init_channels_out
        self.ndim = ndim
        # what the weights cannot encode: the trainer's checkpoint meta
        # sidecar records these, and ``from_checkpoint`` rebuilds from them
        self.tconv_placement = tconv_placement
        self.norm = norm
        self.layout = layout
        self.packed_input = packed_input
        self.packed_output = packed_output
        self.remat = remat
        self.dtype = dtype
        self.mesh = LOCAL
        if layout == "packed":
            self.check_packed()
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
        init_like_flax(self)

    def check_packed(self) -> None:
        """The JAX package's guards of the packed layout."""
        if self.ndim != 3:
            raise ValueError("layout='packed' is 3D-only")
        if self.norm != "batch":
            raise ValueError("layout='packed' supports norm='batch' only")
        if self.n_updownsample_blocks < 1:
            # the f_out=1 unpack rides the last downsample and up_0 takes
            # c0*2 channels: with no blocks the bottleneck would see f2 data
            raise ValueError("layout='packed' needs n_updownsample_blocks >= 1")

    def _run(self, fn, *args):
        """One block: ``fn(*args)``, rematerialised with ``remat``."""
        return remat(fn, *args) if self.remat else fn(*args)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # under spatial partitioning: the patches' global extent along X
        rows = x.shape[2] * self.mesh.space if self.mesh.space > 1 else None
        if self.layout == "packed":
            return self.forward_packed(x, self.packed_input, self.packed_output)
        for name in self.stage_names()[:-1]:
            block = getattr(self, name)
            with span(f"gen.{name}"):
                x = self._run(block, x, rows)
            rows = block.out_rows(rows)
        with span("gen.last_conv"):
            return self._run(self.last_conv, x, rows)

    def stage_names(self) -> tuple:
        """The generator's stages in the order they run: ``first``,
        ``down_<i>``, ``resnet_<i>``, ``up_<i>`` from wide to narrow,
        ``last_conv`` (the JAX generator's module names). Under a running
        profiler each stage's forward, in either layout, is the span
        ``gen.<stage>`` (``utils/spans.py``)."""
        n = self.n_updownsample_blocks
        return ("first", *(f"down_{i}" for i in range(n)), *(f"resnet_{i}" for i in range(self.n_resnet_blocks)),
                *(f"up_{i - 1}" for i in range(n, 0, -1)), "last_conv")

    def forward_packed(self, x: torch.Tensor, packed_input: bool = False, packed_output: bool = False) -> torch.Tensor:
        """The packed layout (``_packed_call`` of the JAX generator): x is
        ``(B, 1, X, Y, Z)``, or f2-packed channels-last with
        ``packed_input``; the output is ``(B, 1, X, Y, Z)``, or f4-packed
        channels-last with ``packed_output``."""
        for _, yp in self.packed_stages(x, packed_input):
            pass
        if packed_output:
            return yp
        return depth_to_space(yp, 4).permute(0, 4, 1, 2, 3)

    def packed_prefix(self, x: torch.Tensor, stage: str) -> torch.Tensor:
        """The packed layout run only up to and including ``stage`` (one of
        :meth:`stage_names`): that stage's output, in the layout the stage
        leaves it (the JAX probe's ``capture_intermediates`` prefix; its
        sum of squares does not depend on the layout)."""
        for name, y in self.packed_stages(x):
            if name == stage:
                return y
        raise ValueError(f"no stage {stage!r} in {self.stage_names()}")

    def packed_stages(self, x: torch.Tensor, packed_input: bool = False):
        """Run the packed layout stage by stage, yielding ``(name, output)``
        after each (:meth:`stage_names`); a consumer that stops early runs
        no later stage. The outputs: the stem, the downsamples and
        ``up_0`` f2-packed channels-last (the last downsample's f1, that
        is, direct channels-last), the ResNet blocks NCDHW, the inner
        upsamples f2-packed, the projection f4-packed."""
        self.check_packed()
        n, dt, space = self.n_updownsample_blocks, self.dtype, self.mesh.space
        if packed_input:
            dims = tuple(2 * d for d in x.shape[1:4])
            xp = x.to(dt)
        else:
            dims = tuple(x.shape[2:])
            xp = space_to_depth(x.permute(0, 2, 3, 4, 1).to(dt), 2)
        # under spatial partitioning x is an X-slab of equal slabs
        dims = (dims[0] * space, *dims[1:])
        block = max(4, 2**n)
        if any(d % block for d in dims):
            raise ValueError(f"spatial dims {dims} must divide {block}")
        note = packed_slab_note(dims[0], space, n)
        if note is not None:
            raise ValueError(note)
        mesh = self.mesh
        # the norms' global block rows at each stage (None: the whole tensor)
        rows = (lambda r: r) if space > 1 else (lambda r: None)

        # stem: reflect-padded 7^3, f2 -> f2
        with span("gen.first"):
            xp = self._run(_packed_stage, self.first, xp, 8, lambda v, k, b: packed_conv3d_padded(
                v, k, b, f_in=2, f_out=2, pad=3, mode="reflect", mesh=mesh), rows(dims[0] // 2))
        yield "first", xp
        # downsamples f2 -> f2; the last one unpacks (f_out=1) into the
        # bottleneck
        for i in range(n):
            f_out = 1 if i == n - 1 else 2
            with span(f"gen.down_{i}"):
                xp = self._run(_packed_stage, getattr(self, f"down_{i}"), xp, f_out**3,
                               lambda v, k, b, fo=f_out: packed_conv3d_padded(
                                   v, k, b, f_in=2, f_out=fo, stride=2, pad=1, mesh=mesh),
                               rows(dims[0] // 2 ** (i + 1) // f_out))
            yield f"down_{i}", xp
        # bottleneck: the direct ResNet blocks on a channels-last view
        x = xp.permute(0, 4, 1, 2, 3)
        for i in range(self.n_resnet_blocks):
            with span(f"gen.resnet_{i}"):
                x = self._run(getattr(self, f"resnet_{i}"), x, rows(dims[0] // 2**n))
            yield f"resnet_{i}", x
        # upsamples: dense stride-1 convs whose s=2-packed output is the f2
        # layout of the full-resolution tensor (the JAX layout runs the
        # inner ones as direct transpose convs: the same products; a
        # forward conv needs no cuDNN backward-data kernel, slow under
        # cudnn.deterministic); the inner ones unpack for the next
        x = x.permute(0, 2, 3, 4, 1)
        for i in range(n, 0, -1):
            with span(f"gen.up_{i - 1}"):
                xp = self._run(_packed_stage, getattr(self, f"up_{i - 1}"), x, 8, lambda v, k, b: packed_tconv3d(
                    v, k, b, stride=2, convention=self.tconv_placement, mesh=mesh), rows(dims[0] // 2**i))
            yield f"up_{i - 1}", xp
            if i > 1:
                x = depth_to_space(xp, 2)
        # the f2 -> f4 projection
        with span("gen.last_conv"):
            yp = self._run(_packed_stage, self.last_conv, xp, 64, lambda v, k, b: packed_conv3d_padded(
                v, k, b, f_in=2, f_out=4, pad=3, mode="reflect", mesh=mesh), rows(dims[0] // 4))
        yield "last_conv", yp
