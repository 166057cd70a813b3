"""Conv building blocks (counterpart of ``contrast_gan_3d_tpu/models/blocks.py``),
2D or 3D (``ndim``), NCHW / NCDHW tensors.

``ConvBlock`` = conv / transpose conv + BatchNorm, LayerNorm,
InstanceNorm or none + dropout + activation, with a bias only when
unnormalized; ``ResNetBlock`` = two ConvBlocks (dropout in the first) +
skip. Weights use torch's layouts: conv
``(O, I, *k)``, transpose conv ``(I, O, *k)`` (``utils/weights.py`` maps the
JAX kernels onto them). Only 3D stride-1 SAME convs take space-to-depth
(``S2DConv``, B3 -> B1), as in the JAX block: the 2D family's convs are
cuDNN's. With ``s2d`` set, a 3D transpose conv is ``D2STConv`` (a dense
stride-1 conv and depth-to-space; no preset sets it).

``dtype`` is the compute dtype, as the JAX modules' ``dtype``: parameters
stay f32; each conv casts its input, weight and bias to ``dtype``, its
output, the bias add, the norm's output and the activation stay in it
(bf16 in, bf16 out). No ``torch.autocast``: its op lists would put the
rounding points elsewhere.

``Dropout`` draws its masks from the train state's ``torch.Generator``
(``set_dropout_generator``), never torch's global one. ``remat`` runs a
block under ``torch.utils.checkpoint``: its activations are recomputed in
the backward (flax ``nn.remat``), with BatchNorm's running statistics and
dropout's masks as the forward left them (the recomputation runs the halo
exchanges again, in the forward's order on every rank).

Spatial partitioning (2D or 3D, ``mesh.space`` > 1,
``models/norm.set_mesh``): ``ConvBlock.forward(x, rows)`` takes an
X-slab (dim 2, H of an NCHW slice) of a tensor whose global extent along
X is ``rows`` and returns this rank's slab of the output
(``out_rows(rows)`` rows): the conv runs VALID along X on the slab
extended by its halo (``parallel/spatial.halo_input``: the neighbours'
rows, the layer's padding only at the global ends), padded along the
other spatial dims as without a mesh. A stride-2 conv's slab starts
wherever its output rows start; a transpose conv takes the input rows its
window reads, on the side ``tconv_placement`` puts it; ``S2DConv`` runs B3 on the extended
slab (``s2d_conv3d_block(halo=True)``, whatever its rows) where Y and Z
divide f. The norms count and sum over the global extent, dropout keeps
its slab of the whole patch's mask. ``rows`` None is the unpartitioned
block.
"""

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from contrast_gan_3d_tpu_torch.models.norm import BatchNorm, InstanceNorm, LayerNorm, recompute_scope, recomputing
from contrast_gan_3d_tpu_torch.ops.block_conv import s2d_conv3d_block
from contrast_gan_3d_tpu_torch.ops.s2d_conv import d2s_tconv3d, reflect_pad
from contrast_gan_3d_tpu_torch.parallel.mesh import LOCAL
from contrast_gan_3d_tpu_torch.parallel.spatial import conv_rows, conv_window, halo_input, tconv_window

class S2DConv(nn.Conv3d):
    """Stride-1 SAME 3D conv computed via space-to-depth and the block-conv
    kernel (``ops/block_conv.s2d_conv3d_block``, B3 -> B1). Parameters are
    those of the ``nn.Conv3d`` it replaces, so checkpoints interchange with
    the direct path. Inputs whose spatial dims do not divide ``f`` take the
    direct conv: the JAX ``ConvBlock``'s per-shape choice (``blocks.py``
    ``use_s2d``), made here once. ``s2d_conv3d_block`` keeps its own check
    only as the JAX wrapper's dispatch for direct callers."""

    def __init__(self, in_channels, out_channels, kernel_size, padding_mode="zeros", f=4, bias=True,
                 dtype=torch.float32):
        super().__init__(
            in_channels, out_channels, kernel_size,
            padding=(kernel_size - 1) // 2, padding_mode=padding_mode, bias=bias,
        )
        self.f = f
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        if any(d % self.f for d in x.shape[2:]):
            return _add_bias(_conv_forward(self, x, w), b)
        y = s2d_conv3d_block(
            x.permute(0, 2, 3, 4, 1), w.permute(2, 3, 4, 1, 0), b, f=self.f, padding_mode=self.padding_mode
        )
        return y.permute(0, 4, 1, 2, 3)

    def forward_slab(self, x: torch.Tensor) -> torch.Tensor:
        """The conv on an X-slab extended by its halo (VALID along X):
        B3 -> B1 on any number of rows where Y and Z divide ``f`` (as
        ``forward``'s choice), else the direct conv."""
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        if any(d % self.f for d in x.shape[3:]):
            return _add_bias(_conv_valid_x(self, x, w), b)
        y = s2d_conv3d_block(x.permute(0, 2, 3, 4, 1), w.permute(2, 3, 4, 1, 0), b, f=self.f,
                             padding_mode=self.padding_mode, halo=True)
        return y.permute(0, 4, 1, 2, 3)


def flax_tconv_kernel(weight: torch.Tensor) -> torch.Tensor:
    """A transpose conv's torch weight (I, O, *k), spatially flipped, back
    to flax's (*k, I, O) (the inverse of ``utils/weights._tconv_kernel``)."""
    nd = weight.dim() - 2
    return weight.flip(tuple(range(2, 2 + nd))).permute(*range(2, 2 + nd), 0, 1)


class D2STConv(nn.ConvTranspose3d):
    """Stride-2 size-preserving 3D transpose conv computed as a dense
    stride-1 conv with s^3-packed output channels and depth-to-space
    (``ops/s2d_conv.d2s_tconv3d``). Parameters are those of the
    ``nn.ConvTranspose3d`` it replaces; ``convention`` is the window
    placement ("torch" or "same", one voxel apart)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=2, bias=True, convention="torch",
                 dtype=torch.float32):
        if convention not in ("torch", "same"):
            raise ValueError(f"unknown tconv_placement {convention!r}")
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, bias=bias)
        self.convention = convention
        self.dtype = dtype
        # where the size-preserving window starts in the full transpose conv
        self.offset = (kernel_size - 1) // 2 if convention == "torch" else _same_tconv_offset(kernel_size, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = d2s_tconv3d(
            x.to(self.dtype).permute(0, 2, 3, 4, 1), flax_tconv_kernel(self.weight).to(self.dtype), self.bias,
            stride=self.stride[0], convention=self.convention,
        )
        return y.permute(0, 4, 1, 2, 3)


def _conv_forward(conv, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``conv``'s own convolution of x with w, no bias; a reflect-padded
    conv pads through ``reflect_pad``, whose backward repeats bit for bit,
    where ``_conv_forward`` would call ``F.pad``'s."""
    if conv.padding_mode != "reflect":
        return conv._conv_forward(x, w, None)
    x = reflect_pad(x, [(p, p) for p in conv.padding], dims=range(2, x.dim()))
    fn = torch.conv3d if x.dim() == 5 else torch.conv2d
    return fn(x, w, None, conv.stride, 0, conv.dilation, conv.groups)


def _conv_valid_x(conv, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``conv``'s convolution of an extended X-slab (NCDHW or NCHW), no
    bias: VALID along X, padded along the other spatial dims as ``conv``
    pads."""
    p = conv.padding[1:]
    if conv.padding_mode == "reflect":
        x = reflect_pad(x, [(q, q) for q in p], dims=range(3, x.dim()))
        p = (0,) * len(p)
    fn = torch.conv3d if x.dim() == 5 else torch.conv2d
    return fn(x, w, None, conv.stride, (0, *p), conv.dilation, conv.groups)


def _add_bias(y: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The conv's bias added after the conv, in y's dtype (flax adds it so)."""
    return y if bias is None else y + bias.view((-1,) + (1,) * (y.dim() - 2))


def _same_tconv_offset(k: int, s: int) -> int:
    """Start of flax ``ConvTranspose(padding='SAME')``'s window in the full
    transpose-conv output (``lax`` pads the dilated input by pad_a in front)."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    return k - 1 - pad_a


class ConvBlock(nn.Module):
    """conv -> norm -> activation over ``ndim`` (2 or 3) spatial dims."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: int,
        stride: int = 1,
        padding: int = 0,
        padding_mode: str = "zeros",
        transpose: bool = False,
        norm: Optional[str] = "batch",
        activation: Optional[str] = "relu",
        negative_slope: float = 0.2,
        dropout_prob: float = 0.0,
        s2d: Optional[int] = None,
        tconv_placement: str = "same",
        dtype: torch.dtype = torch.float32,
        ndim: int = 3,
    ):
        super().__init__()
        if ndim not in (2, 3):
            raise ValueError(f"ndim must be 2 or 3, got {ndim}")
        if padding_mode not in ("reflect", "zeros"):
            raise ValueError(f"unknown padding_mode {padding_mode!r}: expected 'zeros' | 'reflect'")
        if norm not in ("batch", "layer", "instance", None):
            raise ValueError(f"Unknown norm {norm!r}")
        if activation not in ("relu", "leaky_relu", "tanh", None):
            raise ValueError(f"Unknown activation {activation!r}")
        use_bias = norm is None
        self.transpose = transpose
        self.ndim = ndim
        self.dtype = dtype
        self.mesh = LOCAL
        conv_cls = {2: nn.Conv2d, 3: nn.Conv3d}[ndim]
        self.activation = activation
        self.negative_slope = negative_slope
        if transpose and s2d is not None and ndim == 3:
            # the d2s transpose conv (the JAX block's ``use_d2s``)
            self.conv = D2STConv(in_channels, features, kernel_size, stride=stride, bias=use_bias,
                                 convention=tconv_placement, dtype=dtype)
        elif transpose:
            if tconv_placement == "torch":
                # torch ConvTranspose(k, s, p=(k-1)//2, op=s-1) = full[p : p + sN]
                self.tconv_offset = (kernel_size - 1) // 2
            elif tconv_placement == "same":
                self.tconv_offset = _same_tconv_offset(kernel_size, stride)
            else:
                raise ValueError(f"unknown tconv_placement {tconv_placement!r}")
            self.conv = {2: nn.ConvTranspose2d, 3: nn.ConvTranspose3d}[ndim](
                in_channels, features, kernel_size, stride=stride, bias=use_bias
            )
        elif s2d is not None and ndim == 3 and stride == 1 and padding == (kernel_size - 1) // 2:
            self.conv = S2DConv(
                in_channels, features, kernel_size, padding_mode=padding_mode,
                f=s2d, bias=use_bias, dtype=dtype,
            )
        else:
            self.conv = conv_cls(
                in_channels, features, kernel_size, stride=stride, padding=padding,
                padding_mode=padding_mode, bias=use_bias,
            )
        if norm == "batch":
            self.norm = BatchNorm(features, dtype=dtype)
        elif norm == "layer":
            self.norm = LayerNorm(dtype=dtype)
        elif norm == "instance":
            self.norm = InstanceNorm(features, dtype=dtype)
        else:
            self.norm = None
        self.dropout = Dropout(dropout_prob) if dropout_prob > 0 else None

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(self.conv, (S2DConv, D2STConv)):
            return self.conv(x)
        x, w = x.to(self.dtype), self.conv.weight.to(self.dtype)
        if self.transpose:
            # full transpose conv, then the size-preserving window
            s = self.conv.stride[0]
            lo = self.tconv_offset
            tconv = torch.conv_transpose3d if self.ndim == 3 else torch.conv_transpose2d
            y = tconv(x, w, stride=s)
            y = y[(slice(None), slice(None)) + tuple(slice(lo, lo + s * n) for n in x.shape[2:])]
        else:
            y = _conv_forward(self.conv, x, w)
        return _add_bias(y, None if self.conv.bias is None else self.conv.bias.to(self.dtype))

    def out_rows(self, rows: Optional[int]) -> Optional[int]:
        """The output's global extent along X for an input of ``rows``."""
        if rows is None:
            return None
        k, s = self.conv.kernel_size[0], self.conv.stride[0]
        return s * rows if self.transpose else conv_rows(rows, k, s, self.conv.padding[0])

    def _conv_slab(self, x: torch.Tensor, rows: int) -> torch.Tensor:
        """This rank's output rows of the conv of the X-slab ``x`` of a
        global extent ``rows`` (see the module docstring)."""
        conv = self.conv
        k, s = conv.kernel_size[0], conv.stride[0]
        n_out = self.out_rows(rows)
        if self.transpose:
            offset = conv.offset if isinstance(conv, D2STConv) else self.tconv_offset
            window, mode = lambda o0, o1: tconv_window(o0, o1, k, s, offset), "zeros"
        else:
            window, mode = lambda o0, o1: conv_window(o0, o1, k, s, conv.padding[0]), conv.padding_mode
        x, (o0, o1), first = halo_input(x, self.mesh, rows, n_out, window, mode)
        # a rank without output rows computes a phantom one and keeps none
        count = max(o1 - o0, 1)
        if isinstance(conv, S2DConv):
            y = conv.forward_slab(x)
        elif isinstance(conv, D2STConv):
            # row o of the slab's size-preserving output is global row o + s * first
            y = conv(x)[:, :, o0 - s * first:][:, :, :count]
        else:
            w = conv.weight.to(self.dtype)
            x = x.to(self.dtype)
            if self.transpose:
                # the full transpose conv of the slab starts at global row s * first
                lo, start = self.tconv_offset, o0 + self.tconv_offset - s * first
                tconv = torch.conv_transpose3d if self.ndim == 3 else torch.conv_transpose2d
                y = tconv(x, w, stride=s)
                y = y[(slice(None), slice(None), slice(start, start + count))
                      + tuple(slice(lo, lo + s * n) for n in x.shape[3:])]
            else:
                y = _conv_valid_x(conv, x, w)
            y = _add_bias(y, None if conv.bias is None else conv.bias.to(self.dtype))
        return y.narrow(2, 0, o1 - o0)

    def forward(self, x: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
        """``rows``: under spatial partitioning, the global extent along X
        of the slab ``x``; None, a whole tensor."""
        x = self._conv(x) if rows is None else self._conv_slab(x, rows)
        rows = self.out_rows(rows)
        if self.norm is not None:
            x = self.norm(x, rows)
        if self.dropout is not None:
            x = self.dropout(x, rows)
        return self.activate(x)

    def flax_kernel(self) -> torch.Tensor:
        """The conv's f32 weight in flax's (k, k, k, Ci, Co) layout, as the
        block-space ops take it (3D)."""
        w = self.conv.weight
        return flax_tconv_kernel(w) if self.transpose else w.permute(2, 3, 4, 1, 0)

    def activate(self, x: torch.Tensor) -> torch.Tensor:
        if self.activation == "relu":
            x = F.relu(x)
        elif self.activation == "leaky_relu":
            x = F.leaky_relu(x, self.negative_slope)
        elif self.activation == "tanh":
            x = torch.tanh(x)
        return x


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in train mode each element is kept with
    probability ``1 - p`` and the kept ones are scaled by ``1 / (1 - p)`` in
    x's dtype; in eval mode it is the identity. The mask is ``uniform <
    1 - p`` drawn from ``generator``, the train state's ``torch.Generator``
    (``set_dropout_generator``; ``trainer/steps.init_state`` sets it), so it
    follows the state's seed, checkpoints and CUDA-graph replays; a module
    in train mode without one raises rather than draw from torch's global
    generator. Under a data-parallel ``mesh`` every rank draws the global
    batch's mask in lockstep and keeps its slice, as the JAX package's
    GSPMD program draws one mask for the global batch. The last mask is
    kept: a remat block's recomputation applies the mask its forward
    drew."""

    def __init__(self, p: float):
        super().__init__()
        if not 0.0 < p < 1.0:
            raise ValueError(f"dropout probability must lie in (0, 1), got {p}")
        self.p = p
        self.generator: Optional[torch.Generator] = None
        self.mesh = LOCAL
        self.mask: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
        if not self.training:
            return x
        keep = 1.0 - self.p
        if not recomputing():
            if self.generator is None:
                raise RuntimeError("dropout in train mode draws from the train state's generator: "
                                   "set it with models/blocks.set_dropout_generator (init_state does)")
            n = x.shape[0]
            whole = x.shape[2] if rows is None else rows
            shape = (n * self.mesh.data_size, x.shape[1], whole, *x.shape[3:])
            mask = (torch.rand(shape, generator=self.generator, device=x.device) < keep)[self.mesh.global_slice(n)]
            if rows is not None:
                lo, hi = self.mesh.slab(rows)
                mask = mask[:, :, lo:hi]
            self.mask = mask
        return torch.where(self.mask, x / keep, 0.0)


def set_dropout_generator(module: nn.Module, generator: Optional[torch.Generator], mesh=LOCAL) -> None:
    """Draw ``module``'s dropout masks from ``generator``, for ``mesh``'s
    global batch."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator, m.mesh = generator, mesh


def _remat_contexts():
    return contextlib.nullcontext(), recompute_scope()


def remat(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward (flax
    ``nn.remat``): ``torch.utils.checkpoint`` without reentry (the gradient
    penalty's double backward runs through it), without saving the RNG
    states (a CUDA-graph capture may not read them; dropout keeps its mask
    instead), the recomputation in ``recompute_scope``. Without autograd
    it is the plain call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, context_fn=_remat_contexts)


class ResNetBlock(nn.Module):
    """Two 3^ndim ConvBlocks with a residual skip: block0 has no activation,
    dropout sits between the blocks, the skip wraps both."""

    def __init__(
        self,
        features: int,
        kernel_size: int = 3,
        dropout_prob: float = 0.0,
        padding_mode: str = "zeros",
        norm: Optional[str] = "batch",
        dtype: torch.dtype = torch.float32,
        ndim: int = 3,
    ):
        super().__init__()
        self.block0 = ConvBlock(
            features, features, kernel_size, padding=1, padding_mode=padding_mode,
            norm=norm, activation=None, dropout_prob=dropout_prob, dtype=dtype, ndim=ndim,
        )
        self.block1 = ConvBlock(
            features, features, kernel_size, padding=1, padding_mode=padding_mode,
            norm=norm, activation="relu", dtype=dtype, ndim=ndim,
        )

    def forward(self, x: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
        return x + self.block1(self.block0(x, rows), rows)

    @staticmethod
    def out_rows(rows: Optional[int]) -> Optional[int]:
        return rows
